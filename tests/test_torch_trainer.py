"""The port's checkpointer and engine-driven Trainer against the JAX
package's.

- `Checkpointer` on tensors: the round trip, a partial write staying
  invisible, and GC keeping the newest steps (the cases of
  `tests/test_substrate.py`), plus a restore writing into the live state
  and a bf16 leaf that raises;
- the on-disk format is shared: what either package writes, the other
  restores bit for bit;
- the Trainer on reduced qwen1.5-0.5b (batch 2 x 32 tokens), with two
  injected step faults: both packages start from the reference's initial
  state, written as a step-0 checkpoint into both workdirs, and must agree
  in the per-step losses, the eval rows, the step-2 checkpoint and a resume
  that runs only steps 4 and 5.  Tolerance: `tests/test_torch_train.py`'s
  for train steps in f32, rtol = atol = 1e-4;
- the ordering of the in-place step: with two slots and a slow checkpoint
  body, the step after a checkpoint is ready while the checkpoint runs,
  and the checkpoint must still hold the state after its own step.
"""
import json
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import FaultInjector as TFaults  # noqa: E402
from repro_torch.data.pipeline import DataConfig as TData  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
ARCH, BATCH, SEQ = "qwen1.5-0.5b", 2, 32


# ---------------------------------------------------------------------------
# the checkpointer on tensors
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), n_shards=2)
    state = {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(6, 2),
                        "layers": [torch.ones(3), torch.zeros(2, dtype=torch.int32)]},
             "opt": {"m": torch.zeros((6, 2))}}
    ck.save(3, state)
    template = {"params": {"w": torch.empty(6, 2), "layers": [torch.empty(3),
                                                              torch.empty(2, dtype=torch.int32)]},
                "opt": {"m": torch.empty(6, 2)}}
    restored, step = ck.restore(template)
    assert step == 3
    torch.testing.assert_close(restored, state, rtol=0, atol=0)
    with open(ck.manifest_path(3)) as f:
        entries = json.load(f)["entries"]
    assert sorted(entries) == ["opt/m", "params/layers/0", "params/layers/1", "params/w"]
    assert entries["params/w"]["n_shards"] == 2


def test_checkpoint_restore_overwrites_the_template(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.full((4,), 2.0)})
    live = {"w": torch.zeros(4)}
    restored, _ = ck.restore(live)
    assert restored["w"] is live["w"]
    assert torch.equal(live["w"], torch.full((4,), 2.0))
    with pytest.raises(ValueError, match="'w'"):
        ck.restore({"w": torch.zeros(5)})


def test_checkpoint_refuses_a_bf16_leaf(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(TypeError, match="params/w"):
        ck.save(1, {"params": {"w": torch.ones(3, dtype=torch.bfloat16)}})
    assert ck.latest_step() is None


def test_checkpoint_partial_write_is_invisible(tmp_path):
    """A crash before the manifest commit leaves no visible checkpoint."""
    ck = Checkpointer(str(tmp_path))
    state = {"w": torch.ones(4)}
    ck.save(1, state)
    # simulate a crashed step-2 save: shards written, no manifest
    os.makedirs(os.path.join(tmp_path, "step_00000002"), exist_ok=True)
    with open(os.path.join(tmp_path, "step_00000002", "w.shard0000of0001.npz"),
              "wb") as f:
        f.write(b"garbage")
    assert ck.latest_step() == 1
    _, step = ck.restore(state)
    assert step == 1


def test_checkpoint_gc_keeps_recent(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"w": torch.ones(2)}
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    assert ck.steps() == [3, 4]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"blocks": [{"w": rng.standard_normal((5, 3), dtype=np.float32)},
                                  {"w": rng.standard_normal((5, 3), dtype=np.float32)}],
                       "embed": rng.standard_normal((7, 4), dtype=np.float32)},
            "opt": {"m": {"embed": rng.standard_normal((7, 4), dtype=np.float32)},
                    "count": np.array([3], np.int32)}}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_format_is_shared_with_the_reference(tmp_path, writer):
    """What one package writes, the other restores bit for bit."""
    pytest.importorskip("jax")
    from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
    from repro_torch.models.params import tree_map

    tree = _tree()
    as_tensors = tree_map(torch.from_numpy, tree)
    if writer == "reference":
        RefCheckpointer(str(tmp_path), n_shards=2).save(5, tree)
        got, step = Checkpointer(str(tmp_path)).restore(
            tree_map(torch.empty_like, as_tensors))
        torch.testing.assert_close(got, as_tensors, rtol=0, atol=0)
    else:
        Checkpointer(str(tmp_path), n_shards=2).save(5, as_tensors)
        got, step = RefCheckpointer(str(tmp_path)).restore(
            tree_map(np.zeros_like, tree))
        got, exp = _flat(got), _flat(tree)
        assert sorted(got) == sorted(exp)
        for k in exp:
            np.testing.assert_array_equal(np.asarray(got[k]), exp[k], err_msg=k)
    assert step == 5


def _flat(tree):
    from repro_torch.checkpoint.checkpointer import _flatten
    return _flatten(tree)


# ---------------------------------------------------------------------------
# the Trainer, against the reference's
# ---------------------------------------------------------------------------

def _ref_trainer(workdir, tcfg, faults=0):
    from repro.configs import registry as jreg
    from repro.core.faults import FaultInjector
    from repro.data.pipeline import DataConfig
    from repro.optim import adamw
    from repro.train.trainer import Trainer, TrainerConfig

    inj = FaultInjector(seed=0).fail_first_n("train_step", faults) if faults else None
    return Trainer(jreg.smoke_config(ARCH), adamw.Hyper(lr=1e-3, warmup=2),
                   DataConfig(global_batch=BATCH, seq_len=SEQ), str(workdir),
                   TrainerConfig(**tcfg), fault_injector=inj)


def _port_trainer(workdir, tcfg, faults=0):
    inj = TFaults(seed=0).fail_first_n("train_step", faults) if faults else None
    return ttrainer.Trainer(treg.smoke_config(ARCH), tadamw.Hyper(lr=1e-3, warmup=2),
                            TData(global_batch=BATCH, seq_len=SEQ), str(workdir),
                            ttrainer.TrainerConfig(**tcfg), fault_injector=inj,
                            device="cpu")


def _rows(hist):
    """(train rows, eval rows) without the host's step times."""
    train = [{k: v for k, v in r.items() if k != "step_time"} for r in hist if "loss" in r]
    return train, [r for r in hist if "eval_loss" in r]


def _close_rows(got, exp):
    assert [r["step"] for r in got] == [r["step"] for r in exp]
    for g, e in zip(got, exp):
        assert sorted(g) == sorted(e)
        np.testing.assert_allclose([g[k] for k in sorted(g)], [e[k] for k in sorted(e)], **F32)


def _ckpt_leaves(workdir, step):
    """{key: array} of a checkpoint, read through its manifest."""
    sdir = os.path.join(workdir, "ckpt", f"step_{step:08d}")
    with open(os.path.join(sdir, "MANIFEST.json")) as f:
        entries = json.load(f)["entries"]
    return {k: np.concatenate([np.load(os.path.join(
        sdir, f"{e['name']}.shard{i:04d}of{e['n_shards']:04d}.npz"))["data"]
        for i in range(e["n_shards"])]) for k, e in entries.items()}


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """Both workdirs, holding the reference's initial state as a step-0
    checkpoint, and each package's run of 4 steps from it with two injected
    faults, then a resume to 6."""
    pytest.importorskip("jax")
    root = tmp_path_factory.mktemp("trainer")
    ref_dir, port_dir = root / "ref", root / "port"
    first = dict(total_steps=4, ckpt_every=2, eval_every=2)
    ref = _ref_trainer(ref_dir, first, faults=2)
    params, opt = ref.init_state()
    ref.ckpt.save(0, {"params": params, "opt": opt})
    shutil.copytree(ref_dir / "ckpt", port_dir / "ckpt")
    port = _port_trainer(port_dir, first, faults=2)
    out = {"dirs": (str(ref_dir), str(port_dir)),
           "first": (ref.fit(), port.fit()),
           "stats": (ref.engine_stats, port.engine_stats),
           "retried": (len(ref.vdc.failures()), len(port.vdc.failures()))}
    again = dict(total_steps=6, ckpt_every=2, eval_every=0)
    out["resume"] = (_ref_trainer(ref_dir, again).fit(), _port_trainer(port_dir, again).fit())
    return out


def test_trainer_matches_reference_with_injected_faults(carried):
    ref, port = carried["first"]
    assert carried["stats"][0]["failed"] == carried["stats"][1]["failed"] == 0
    assert carried["retried"] == (2, 2)
    (ref_train, ref_eval), (port_train, port_eval) = _rows(ref), _rows(port)
    assert [r["step"] for r in port_train] == [0, 1, 2, 3]
    _close_rows(port_train, ref_train)
    assert [r["step"] for r in port_eval] == [2, 4]
    _close_rows(port_eval, ref_eval)


def test_trainer_checkpoint_matches_reference(carried):
    ref_dir, port_dir = carried["dirs"]
    ref, port = _ckpt_leaves(ref_dir, 2), _ckpt_leaves(port_dir, 2)
    assert sorted(port) == sorted(ref) and len(ref) > 20
    for k in ref:
        assert port[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_allclose(port[k], ref[k], err_msg=k, **F32)


def test_trainer_resume_runs_only_the_remaining_steps(carried):
    ref, port = carried["resume"]
    (ref_train, _), (port_train, _) = _rows(ref), _rows(port)
    assert [r["step"] for r in port_train] == [r["step"] for r in ref_train] == [4, 5]
    _close_rows(port_train, ref_train)


def test_checkpoint_holds_its_own_step_when_the_next_step_is_ready(tmp_path, monkeypatch):
    """Two engine slots and a checkpoint body that sleeps before it saves:
    `data(3)` returns at once, so `step(3)` would run (and update the state
    in place) during the checkpoint of step 2.  The step-2 checkpoint must
    equal the state after exactly two steps of a bare loop."""
    from repro_torch.core import LocalProvider, ThreadExecutorPool
    from repro_torch.core.engine import Engine
    from repro_torch.train import init_params
    from repro_torch.train.steps import make_train_step

    pools = []

    def two_slots(self, concurrency=1):
        pool = ThreadExecutorPool(self.clock, workers=2)
        pools.append(pool)
        return self.add_site("localhost", LocalProvider(self.clock, 2, pool=pool),
                             capacity=2)

    monkeypatch.setattr(Engine, "local_site", two_slots)
    tr = _port_trainer(tmp_path, dict(total_steps=4, ckpt_every=2, eval_every=0))
    save = tr.ckpt.save
    steps_during = []       # steps that finished while a checkpoint slept

    def slow_save(step, state):
        n = len(tr.history)
        time.sleep(0.5)
        steps_during.extend(r["step"] for r in tr.history[n:])
        save(step, state)

    tr.ckpt.save = slow_save
    try:
        tr.fit()
    finally:
        for p in pools:
            p.shutdown()
    assert [r["step"] for r in tr.history] == [0, 1, 2, 3]
    assert tr.ckpt.steps() == [2, 4] and steps_during == []

    cfg = treg.smoke_config(ARCH)
    params = init_params(cfg, 0, "cpu")
    opt = tadamw.init(params)
    step_fn = make_train_step(cfg, tr.hp)
    for s in range(2):
        batch = {k: torch.from_numpy(v) for k, v in tr.data.global_batch(s).items()}
        params, opt, _ = step_fn(params, opt, batch, s)
    got = _ckpt_leaves(str(tmp_path), 2)
    exp = {k: v.numpy() for k, v in _flat({"params": params, "opt": opt}).items()}
    assert sorted(got) == sorted(exp)
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    args = (treg.smoke_config(ARCH), tadamw.Hyper(), TData(global_batch=BATCH, seq_len=SEQ),
            str(tmp_path))
    if torch.cuda.is_available():
        assert ttrainer.Trainer(*args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrainer.Trainer(*args)
    assert ttrainer.Trainer(*args, device="cpu").device.type == "cpu"


def test_train_entry_point_resumes_from_its_workdir(tmp_path, capsys):
    """`python -m repro_torch.train --workdir DIR`: a second run with more
    steps resumes from the newest checkpoint under DIR (one every 2 steps)."""
    from repro_torch.train import main

    argv = ["--smoke", "--arch", ARCH, "--seq-len", str(SEQ), "--batch", str(BATCH),
            "--microbatches", "1", "--device", "cpu", "--workdir", str(tmp_path)]
    first = main(argv + ["--steps", "3"])
    second = main(argv + ["--steps", "4"])
    assert [r["step"] for r in first if "loss" in r] == [0, 1, 2]
    assert [r["step"] for r in second if "loss" in r] == [2, 3]
    assert [r["step"] for r in second if "eval_loss" in r] == [4]
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps_run"] == [2, 3] and summary["checkpoints"] == [2, 4]
