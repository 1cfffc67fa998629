"""program_idle_share.prefill (%): the device's idle seconds in the traced
slice whose ending op the port launched inside one of its `repro.*` spans,
over the slice's wall time (`harness/spans.py`).  `idle_share.prefill`
less this is the share of the gaps ended by work the harness launched
outside the program's steps (the prompts' draws, the first token's argmax
and its read) or by the slice's end.  Nothing where the program opens no
span."""
from portbench.harness import spans


def read(rec):
    sp = spans.read(rec)
    if sp is None:
        return None
    return 100.0 * sp.program_idle_s / sp.window_s
