"""The reference's example workflows whose task bodies are JAX code, with
torch bodies on a device: `quickstart`, `moldyn_workflow`,
`montage_workflow` and `fmri_workflow`.  Each runs the same tasks, names
and dataflow through `repro_torch.core`, on the card by default
(`device="cuda"`; `--device cpu` on the command line), and its `run()`
returns the results, the engine's `stats()` and the VDC's summary.

Run:  PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]
"""
