"""Images whose scores, labels and keypoints reached the host inside the
window, over the window's seconds (host clock)."""
import math


def read(run):
    if run.trace_run or not run.window_s:
        return None
    done = sum(1 for t in run.latencies if math.isfinite(t))
    return done * run.traffic["batch"] / run.window_s
