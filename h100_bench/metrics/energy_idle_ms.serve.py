"""Ms a batch inside the program's span ``decoder.energy`` (gradient energy
refinement) in which no kernel, copy or memset ran on the device: the
span's length less its overlap with the device's busy intervals."""
from h100_bench.metrics._energy import ENERGY
from h100_bench.metrics._program import idle_inside_s, per_call


def read(run):
    return per_call(run, ENERGY, lambda tr: 1e3 * idle_inside_s(tr, ENERGY))
