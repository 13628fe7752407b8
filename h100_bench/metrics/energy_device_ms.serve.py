"""Device ms a batch of the work launched inside the program's span
``decoder.energy`` (gradient energy refinement) on any host thread: its
forwards on the main thread and each step's backward on autograd's
(``_energy.py`` says why that is sound)."""
from h100_bench.metrics._energy import ENERGY, launched_in_energy
from h100_bench.metrics._program import per_call


def read(run):
    return per_call(run, ENERGY, lambda tr: sum(d[3] for d in launched_in_energy(tr)) / 1e3)
