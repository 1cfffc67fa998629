"""The traffic mixes: seeded, and the same sizes for every seed."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.drivers import prefill  # noqa: E402
from portbench.harness.stats import derive  # noqa: E402

MIX = json.loads((ROOT / "portbench" / "traffic" / "long_prefill.json").read_text())
BIG = 2**31 + 977


def test_the_same_seed_gives_the_same_cycles():
    assert [prefill.cycle_order(MIX, BIG, c) for c in range(8)] == \
        [prefill.cycle_order(MIX, BIG, c) for c in range(8)]


def test_each_cycle_sends_each_length_once_and_every_seed_the_same_sizes():
    for seed in (0, 1, BIG, -5, 2**64 + 3):
        for c in range(6):
            assert sorted(prefill.cycle_order(MIX, seed, c)) == sorted(MIX["prompt_lengths"])
    orders = {tuple(prefill.cycle_order(MIX, s, 0)) for s in range(40)}
    assert len(orders) > 1                       # the seed sets the order


def test_every_batch_holds_tokens_per_batch_tokens():
    for S in MIX["prompt_lengths"]:
        B, S2 = prefill.batch_shape(MIX, S)
        assert B * S2 == MIX["tokens_per_batch"]
    counts = [MIX["tokens_per_batch"] // S for S in MIX["prompt_lengths"]]
    assert counts == [16, 8, 4, 2, 1] and sum(counts) == 31


def test_prompts_are_a_function_of_seed_and_batch():
    import torch

    class Ctx:
        device, seed, vocab = torch.device("cpu"), BIG, 151936

    a = prefill.prompts(Ctx, (3, 1), 2, 64)
    assert torch.equal(a, prefill.prompts(Ctx, (3, 1), 2, 64))
    assert not torch.equal(a, prefill.prompts(Ctx, (3, 2), 2, 64))
    assert int(a.max()) < Ctx.vocab and int(a.min()) >= 0


def test_sub_seeds_take_any_whole_seed():
    assert derive(BIG, "x") == derive(BIG, "x") != derive(BIG + 1, "x")
    assert 0 <= derive(-(2**70), "y") < 2**63
