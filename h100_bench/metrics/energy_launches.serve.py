"""Kernels, copies and memsets a batch launched inside the program's span
``decoder.energy`` (gradient energy refinement) on any host thread
(``_energy.py``)."""
from h100_bench.metrics._energy import ENERGY, launched_in_energy
from h100_bench.metrics._program import per_call


def read(run):
    return per_call(run, ENERGY, lambda tr: len(launched_in_energy(tr)))
