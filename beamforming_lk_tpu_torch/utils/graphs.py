"""A step replayed as CUDA graphs (the port's counterpart of XLA compiling
a scan into one dispatch).

A CUDA graph records the kernels a stream runs once and launches them
again as one unit, so a step of hundreds of small kernels costs the host
one launch.  :class:`StepGraphs` runs ``fn(*args) -> outputs`` (pytrees of
tensors and host values) so:

- the first call with a host ``key`` runs ``fn`` eagerly, which loads its
  kernels and libraries before anything is captured;
- the second captures ``fn`` on static copies of the arguments, with every
  ``torch.Generator`` among them registered, so that each replay advances
  it exactly as the eager draws do, then replays it;
- every call from then on copies the arguments into the static operands
  (one ``cat`` a dtype for the contiguous tensors, one copy for each other
  tensor), replays, and returns the outputs as views of fresh copies of the
  graph's packed outputs (one copy a dtype): no result a call returned is
  overwritten by a later call.

The key must decide every host value ``fn`` reads; the host values among
the outputs are those of the capture, and the caller sets anew any that
change from call to call.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from beamforming_lk_tpu_torch.utils import profiling


class _Slot(NamedTuple):
    """Where a tensor leaf lives in a graph's static memory: ``packed`` (a
    view of its dtype's flat buffer) or not (a buffer of its own)."""

    tensor: torch.Tensor
    packed: bool


class _Place(NamedTuple):
    """An output tensor: piece ``index`` of its dtype's packed outputs,
    viewed as ``shape`` (None where the piece has its shape already)."""

    dtype: torch.dtype
    index: int
    shape: Optional[torch.Size]


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    flat_in: dict        # dtype -> the packed static inputs
    slots: list          # per input leaf: _Slot, or None for a host value
    flat_out: dict       # dtype -> the packed outputs, in the graph's pool
    sizes: dict          # dtype -> the elements of each packed output
    out_leaves: list     # per output leaf: _Place, or a host value
    out_spec: object
    launches: tuple      # counted launches one replay makes, per counter


def _by_dtype(tensors) -> dict:
    """dtype -> the tensors of that dtype, in order."""
    groups = {}
    for x in tensors:
        groups.setdefault(x.dtype, []).append(x)
    return groups


def _load(flat_in, slots, leaves) -> None:
    """Copy a call's tensors into a graph's static operands."""
    groups = {dtype: [] for dtype in flat_in}
    for leaf, slot in zip(leaves, slots):
        if slot is None:
            continue
        if leaf.shape != slot.tensor.shape or leaf.dtype != slot.tensor.dtype:
            raise ValueError(
                f"a graph captured for {tuple(slot.tensor.shape)} "
                f"{slot.tensor.dtype} was given {tuple(leaf.shape)} {leaf.dtype}")
        if slot.packed:
            groups[leaf.dtype].append(leaf if leaf.dim() == 1 else leaf.reshape(-1))
        else:
            slot.tensor.copy_(leaf)
    for dtype, flat in flat_in.items():
        torch.cat(groups[dtype], out=flat)


class StepGraphs:
    """``fn`` replayed as one CUDA graph a host key (module docstring).

    ``counters``: functions whose ``launches`` attribute counts kernel
    launches (``ops.cuda_tracker.monopulse_chain``): the capture leaves
    them as they were and each replay adds the launches it makes.  Each
    replay runs inside the span ``span``.  :attr:`captures` and
    :attr:`replays` count the graphs captured and replayed."""

    def __init__(self, fn, counters, span: str):
        self.fn = fn
        self.counters = tuple(counters)
        self.span = span
        self.captures = self.replays = 0
        self._seen = set()
        self._graphs = {}

    def __call__(self, key, *args):
        leaves, spec = pytree.tree_flatten(args)
        generators = tuple(x for x in leaves if isinstance(x, torch.Generator))
        key = (key,) + generators
        entry = self._graphs.get(key)
        if entry is None:
            if key not in self._seen:
                self._seen.add(key)
                return self.fn(*args)
            entry = self._graphs[key] = self._capture(leaves, spec, generators)
        with profiling.span(self.span):
            _load(entry.flat_in, entry.slots, leaves)
            entry.graph.replay()
            for counter, n in zip(self.counters, entry.launches):
                counter.launches += n
            self.replays += 1
            return self._unload(entry)

    @staticmethod
    def _unload(entry: _Graph):
        """The outputs of the last replay, as views of fresh copies."""
        pieces = {dtype: flat.clone().split_with_sizes(entry.sizes[dtype])
                  for dtype, flat in entry.flat_out.items()}
        leaves = []
        for x in entry.out_leaves:
            if isinstance(x, _Place):
                piece = pieces[x.dtype][x.index]
                x = piece if x.shape is None else piece.view(x.shape)
            leaves.append(x)
        return pytree.tree_unflatten(leaves, entry.out_spec)

    def _capture(self, leaves, spec, generators) -> _Graph:
        """Capture ``fn`` on static operands shaped as ``leaves``."""
        packed = _by_dtype(x for x in leaves
                           if isinstance(x, torch.Tensor) and x.is_contiguous())
        flat_in = {dtype: torch.empty(sum(x.numel() for x in xs), dtype=dtype,
                                      device=xs[0].device)
                   for dtype, xs in packed.items()}
        pieces = {dtype: iter(flat_in[dtype].split_with_sizes([x.numel() for x in xs]))
                  for dtype, xs in packed.items()}
        slots = [None if not isinstance(x, torch.Tensor)
                 else _Slot(next(pieces[x.dtype]).view(x.shape), True)
                 if x.is_contiguous()
                 else _Slot(torch.empty(x.shape, dtype=x.dtype, device=x.device), False)
                 for x in leaves]
        statics = [x if slot is None else slot.tensor for x, slot in zip(leaves, slots)]
        _load(flat_in, slots, leaves)    # the capture sees this call's values

        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        before = tuple(c.launches for c in self.counters)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self.fn(*pytree.tree_unflatten(statics, spec))
            out_leaves, out_spec = pytree.tree_flatten(out)
            # One copy of each distinct output tensor (an output that
            # aliases another comes back aliased).
            by_dtype = _by_dtype({id(x): x for x in out_leaves
                                  if isinstance(x, torch.Tensor)}.values())
            flat_out = {dtype: torch.cat([x.reshape(-1) for x in xs])
                        for dtype, xs in by_dtype.items()}
        launches = tuple(c.launches - b for c, b in zip(self.counters, before))
        for c, b in zip(self.counters, before):
            c.launches = b      # the capture ran nothing; the replays count
        place = {id(x): _Place(dtype, i, None if x.dim() == 1 else x.shape)
                 for dtype, xs in by_dtype.items() for i, x in enumerate(xs)}
        sizes = {dtype: [x.numel() for x in xs] for dtype, xs in by_dtype.items()}
        self.captures += 1
        return _Graph(graph, flat_in, slots, flat_out, sizes,
                      [place[id(x)] if isinstance(x, torch.Tensor) else x
                       for x in out_leaves], out_spec, launches)
