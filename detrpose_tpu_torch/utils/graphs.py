"""The eval forward's dispatch on the card: constants kept on the device,
and stages replayed as CUDA graphs.

A tensor the forward builds from numpy (position-embedding frequencies,
anchors, FDR bin values, the MSDA location normaliser) reaches the card by
a copy from pageable host memory, which ends in a stream synchronise: the
host waits until the device has drained its queue, so it can never run
ahead of the device, and a CUDA graph cannot capture such a copy.
``device_constant`` builds each such tensor once per key (its shapes and
widths, the device) and hands the same tensor to every later call.

``GraphedStage`` is the base of a stage (``models/hgnetv2.py::HGNetv2``,
``models/hybrid_encoder.py::HybridEncoder``) whose eval forward on the card
replays a ``torch.cuda.CUDAGraph``: two host calls in place of hundreds of
launches, so the eager transformer after them is dispatched while the
device still works through the stages' queued kernels. The kernels and
their arithmetic are those of the eager forward. A graph engages only where
the input allows it (``eager_reason``); everywhere else, on the CPU, in
training, with autograd recording, under autocast or under torch.compile or
torch.export, the stage runs its eager forward.
"""
from __future__ import annotations

import functools
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from .measure import span

# every ``device_constant``, for the tests that read what each keeps
CONSTANTS: List[Callable] = []

# id -> tensor of each graph's static outputs, so that a stage given another
# stage's output reads it where it lies
_STATIC_OUTPUTS: "weakref.WeakValueDictionary[int, torch.Tensor]" = (
    weakref.WeakValueDictionary())


def tracing() -> bool:
    """Whether the forward runs under torch.compile or torch.export, or with
    a fake tensor mode active: its tensors then stand for data they do not
    hold."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return True
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def device_constant(build: Callable) -> Callable:
    """``build(*args, **kwargs)``, a tensor or a tuple of tensors, built
    once per arguments (hashable: shapes, widths, the device) and kept for
    the life of the process. Every caller gets the same tensors and must not
    write to them. Under a trace (``tracing``) they are built afresh and not
    kept."""
    cache: Dict = {}

    @functools.wraps(build)
    def get(*args, **kwargs):
        if tracing():
            return build(*args, **kwargs)
        key = (args, tuple(sorted(kwargs.items())))
        value = cache.get(key)
        if value is None:
            # normal tensors even under inference mode: training saves them
            # for its backward
            with torch.inference_mode(False):
                value = cache[key] = build(*args, **kwargs)
        return value

    get.cache = cache
    CONSTANTS.append(get)
    return get


def eager_reason(module: nn.Module, inputs: Sequence[torch.Tensor]) -> Optional[str]:
    """Why ``module``'s forward on ``inputs`` runs eagerly, or None where it
    can replay a graph: "training" (the module is in training mode), "grad"
    (autograd records), "autocast" (CUDA autocast is on: a capture would keep
    the weights' casts that autocast caches, made from the weights of that
    moment), "tracing" (``tracing``) or "device" (an input is not a plain
    CUDA tensor)."""
    if module.training:
        return "training"
    if torch.is_grad_enabled():
        return "grad"
    if torch.is_autocast_enabled("cuda"):
        return "autocast"
    if tracing():
        return "tracing"
    if not all(type(t) is torch.Tensor and t.is_cuda for t in inputs):
        return "device"
    return None


class _Graph:
    """One captured forward: its static inputs, the graph, its static
    outputs."""

    def __init__(self, run: Callable, x, inputs: List[torch.Tensor]):
        dev = inputs[0].device
        # another graph's output is read where it lies, anything else copied
        self.inputs = [t if _STATIC_OUTPUTS.get(id(t)) is t else t.clone() for t in inputs]
        args = self.inputs[0] if isinstance(x, torch.Tensor) else list(self.inputs)
        with torch.cuda.device(dev):
            # the warm-up meets every lazy set-up (constants, library
            # handles, algorithm choices) outside the capture
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run(args)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.outputs = list(run(args))
        for t in self.outputs:
            _STATIC_OUTPUTS[id(t)] = t

    def replay(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        for static, t in zip(self.inputs, inputs):
            if static is not t:
                static.copy_(t)
        self.graph.replay()
        return list(self.outputs)


class GraphedStage(nn.Module):
    """A stage whose eval forward on the card replays CUDA graphs.

    A subclass writes ``run``, its eager forward: a tensor or a list of
    tensors in, a list of tensors out. ``forward`` calls it where
    ``eager_reason`` names a reason; else it replays the graph of the
    inputs' key (shape, stride, dtype and device of each input), captured at
    the first call with that key after a warm-up run of it on a side stream.
    Each input is copied into the graph's static input, unless it is the
    very tensor the graph reads (another graph's static output, such as the
    backbone's features handed to the encoder). The replay opens the span
    ``forward.graph``; the spans inside ``run`` open only when it runs.

    A replay returns the graph's static outputs, which its next replay, or
    a copy into them as another stage's static inputs, overwrites: a caller
    keeps them only until the model's next call at that key (the
    transformer reads them and returns tensors of its own). Weights are read
    where they lie, so ``load_state_dict``, which copies in place, needs no
    new capture; ``.to(...)`` and the other conversions that replace their
    storage (``_apply``) drop the graphs, and so does ``train()``, to give
    their memory back. One graph and memory pool is kept per key.
    """

    def __init__(self):
        super().__init__()
        self._graphs: Dict[tuple, _Graph] = {}

    def run(self, x):
        raise NotImplementedError

    def forward(self, x):
        inputs = [x] if isinstance(x, torch.Tensor) else list(x)
        if eager_reason(self, inputs) is not None:
            return self.run(x)
        key = tuple((tuple(t.shape), t.stride(), t.dtype, t.device) for t in inputs)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _Graph(self.run, x, inputs)
        with span("forward.graph"):
            return graph.replay(inputs)

    def train(self, mode: bool = True):
        if mode:
            self._graphs.clear()
        return super().train(mode)

    def _apply(self, fn, recurse=True):
        self._graphs.clear()
        return super()._apply(fn, recurse)
