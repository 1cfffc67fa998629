"""The paper's MolDyn free-energy workflow (§5.4.3), 1 + 20 N tasks for N
molecules, with small torch bodies on a device standing in for CHARMM,
Antechamber and WHAM, run through Falkon with dynamic resource provisioning
and a restart log: the counterpart of the reference's
`examples/moldyn_workflow.py`.  A second run on the same `--workdir`
restores the durable stages (`annotate`, `wham`) from the log.

Run:  PYTHONPATH=src python -m repro_torch.examples.moldyn_workflow \\
          [--molecules N] [--workdir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import (DRPConfig, Engine, FalkonConfig, FalkonProvider,
                              FalkonService, RealClock, RestartLog, Workflow)
from repro_torch.device import resolve_device

N_CHARMM = 17  # scaled from the paper's 68 parallel CHARMM jobs


def run(molecules: int = 8, workdir: str | None = None, device="cuda") -> dict:
    """The workflow over `molecules` molecules, its restart log under
    `workdir` (made if missing; a new temporary directory by default)."""
    dev = resolve_device(device)
    workdir = workdir or tempfile.mkdtemp(prefix="moldyn_")
    os.makedirs(workdir, exist_ok=True)
    clock = RealClock()
    engine = Engine(clock, restart_log=RestartLog(os.path.join(workdir, "restart.log")))
    svc = FalkonService(clock, FalkonConfig(drp=DRPConfig(max_executors=8, alloc_latency=0.0)))
    engine.add_site("cluster", FalkonProvider(svc), capacity=8)
    wf = Workflow("moldyn", engine)

    @wf.atomic(durable=True)
    def annotate(mol_id):
        rng = np.random.default_rng(mol_id)
        return float(rng.standard_normal())  # "charges"

    @wf.atomic
    def antechamber(charge, mol_id):
        # per-molecule topology from the shared charge annotation
        return [float(charge) * (k + 1) + 0.1 * mol_id for k in range(4)]

    @wf.atomic
    def charmm_equilibrate(topo):
        return torch.tanh(torch.tensor(topo, device=dev)).tolist()

    @wf.atomic
    def charmm_pert(state, lam):
        x = torch.tensor(state, device=dev)
        return float(torch.sum(torch.exp(-lam * x ** 2)))

    @wf.atomic(durable=True)
    def wham(energies, mol_id):
        e = torch.tensor(energies, device=dev)
        # free energy estimate from the perturbation energies
        return float(-torch.log(torch.mean(torch.exp(-e / e.std(correction=0)))))

    def molecule(mol_id, charges):
        topo = antechamber(charges, mol_id)
        eq = charmm_equilibrate(topo)
        lams = [0.1 + 0.05 * k for k in range(N_CHARMM)]
        energies = wf.gather([charmm_pert(eq, lam) for lam in lams])
        return wham(energies, mol_id)

    charges = annotate(0)  # stage 1: once for all molecules
    results = wf.gather([molecule(m, charges) for m in range(molecules)])
    wf.run()
    return {"energies": results.get(), "utilization": svc.utilization(),
            "stats": engine.stats(), "vdc": engine.vdc.summary(), "workdir": workdir}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--molecules", type=int, default=8)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.molecules, args.workdir, args.device)
    u = r["utilization"]
    print(f"moldyn: {args.molecules} molecules -> free energies "
          f"{[f'{e:.3f}' for e in r['energies'][:5]]}...")
    print(f"falkon: {u['dispatched']} tasks dispatched, efficiency {u['efficiency']:.1%}, "
          f"restored from restart log: {r['stats']['restored_from_log']}")
    print(f"(re-run with --workdir {r['workdir']} to see the restart log skip the "
          f"durable stages)")


if __name__ == "__main__":
    main()
