"""A chunk of K Gibbs iterations as one CUDA graph: the H100's form of the
TPU kernel ``ops/pallas/megachain.py::gcr_megachain``, which runs a chunk
as one program (:1-10, 469-694).

On the card an iteration is a fixed sequence of some 38 launches of the
hand-written kernels plus a few torch ops. Launched from Python one at a
time, each pays for its wrapper and a ``ctypes`` call, and the device
idles between the short ones. :class:`ChunkGraph` captures the whole
chunk once with ``torch.cuda.graph`` and replays it: the host then issues
one launch a chunk. What makes a chunk capturable:

* nothing in it reads back to the host: the megachain warm start decides
  its rebuilds on the device (``herm_inv`` in gate mode);
* no host-to-device copy: the caller makes every index and table tensor
  before (the chunk bodies of ``models/megachain.py`` and
  ``models/mega.py`` do);
* the keyed launches (``draw_rhs``, ``draw_system``, ``bandpower``) read
  the chunk's first iteration from the device counter :attr:`ChunkGraph.g0`
  plus their static offset k, so a replay draws the words of its own
  iterations, bit for bit the words of the eager run.

The graph owns its static inputs (``ps_in``, ``g0``), its outputs, in its
own memory pool, and the body, whose closure holds the chain's operators,
tables, prior bins, stream ids and index tensors: every address the graph
reads stays allocated while the graph lives. The caller owns the graph
(the runner per run, ``run_chain_megachain`` per call): graphs are never
looked up by a tensor's address, so a freed and reused address is never
replayed.
"""
import gc
import time
import weakref
from typing import Callable

import torch

from . import _build

WARMUP_ITERS = 2   # the eager warm-up: k == 0 and one k > 0 iteration


class ChunkGraph:
    """``body(ps, g0, k_total)`` -- a chunk of ``k_total`` iterations from
    the bandpowers ``ps`` at the global iteration held in ``g0`` ((1,)
    int32 on the device), returning its outputs -- captured once for
    ``k_total`` iterations and replayed.

    Construction runs one eager warm-up of ``min(k_total, 2)`` iterations
    (every kernel and every code path of the chunk, loaded before the
    capture), then captures ``body`` into a graph with its own memory pool
    and instantiates it. A failure raises: there is no fallback to the
    eager loop. The warm-up's launches and the capture's recorded ones are
    not counted in ``_build.LAUNCHES``; each replay adds the capture's.

    :meth:`replay` returns the outputs captured, views of the graph's
    static tensors: valid until the next replay. A caller that keeps a
    chunk's outputs past the next one copies them first, or runs the next
    chunk in another graph (:class:`GraphSlots`)."""

    def __init__(self, body: Callable, ps: torch.Tensor, k_total: int):
        if ps.device.type != "cuda":
            raise ValueError("a chunk graph runs on a CUDA device")
        dev = ps.device
        self.body = body   # its closure holds the tensors the graph reads
        self.ps_in = ps.clone()
        self.g0 = torch.zeros((1,), dtype=torch.int32, device=dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with _build.counted(), torch.cuda.stream(side):
            body(self.ps_in, self.g0, min(k_total, WARMUP_ITERS))
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        # no garbage collection inside the capture: freeing a dead cycle's
        # CUDA graphs or events there would invalidate it (the one guard
        # against that; the port's own graph owners hold no cycle)
        collecting = gc.isenabled()
        gc.disable()
        try:
            # a capture stream of this graph's device: torch.cuda.graph's
            # default is one stream for the process, on the device that was
            # current at its first capture
            with _build.counted() as rec, torch.cuda.graph(
                    self.graph, stream=torch.cuda.Stream(device=dev)):
                reserved0 = torch.cuda.memory_reserved(dev)
                allocated0 = torch.cuda.memory_allocated(dev)
                self.out = body(self.ps_in, self.g0, k_total)
                self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0
                self.output_bytes = (torch.cuda.memory_allocated(dev)
                                     - allocated0)
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.graph.instantiate()
        self.instantiate_s = time.perf_counter() - t0
        self.launches = rec.launches

    def replay(self, ps: torch.Tensor, iter0):
        """The chunk from bandpowers ``ps`` at global iteration ``iter0``
        (an int): both are copied into the static inputs on the current
        stream, then the graph is launched."""
        self.ps_in.copy_(ps)
        self.g0.fill_(int(iter0))
        self.graph.replay()
        _build.add_launches(self.launches)
        return self.out


class GraphSlots:
    """Graph caches that a caller alternates chunk by chunk (chunk i
    replays the graphs of :meth:`cache` ``(i)``): chunk i's outputs are
    the static tensors of its slot's graphs, so they stay valid while
    chunk i+1 runs in the other slot, until chunk i+2 replays the first
    again. The caller orders that replay after its last read of chunk i
    (the runner makes the compute stream wait on chunk i's copy).

    A key's graph is captured in every slot at the key's first use, so a
    run pays its captures before its first replay and its second chunk is
    already a replay, unless no later chunk of the key follows
    (``ahead=False``, a run's shorter last chunk): then only its own slot
    captures it."""

    def __init__(self, n: int = 2):
        self.caches = tuple(_SlotCache(self) for _ in range(n))

    def cache(self, chunk: int, ahead: bool = True) -> dict:
        """The graph cache of chunk number ``chunk``."""
        c = self.caches[chunk % len(self.caches)]
        c.ahead = ahead
        return c


class _SlotCache(dict):
    """One slot's graphs by key; ``ahead``: capture a new key in every
    slot of ``slots``."""

    def __init__(self, slots: GraphSlots):
        super().__init__()
        # a weak reference: a run's slots and graphs (their memory pools)
        # are freed when the run drops them, not at the collector's next
        # pass over a cycle
        self._slots = weakref.ref(slots)
        self.ahead = True

    @property
    def slots(self) -> GraphSlots:
        slots = self._slots()
        if slots is None:
            raise RuntimeError("a graph cache used after its GraphSlots "
                               "was freed: keep the GraphSlots while its "
                               "caches are in use")
        return slots


def replay_chunk(graphs: dict, key, make_body: Callable, ps: torch.Tensor,
                 k_total: int, iter0):
    """The chunk of ``k_total`` iterations from ``ps`` at ``iter0`` through
    the caller's graph of ``key`` in ``graphs``, captured from
    ``make_body()`` at its first use and replayed after. ``graphs`` is a
    dict, or a :class:`GraphSlots` cache (each slot capturing its own
    graph from its own body)."""
    if key not in graphs:
        peers = (graphs.slots.caches if getattr(graphs, "ahead", False)
                 else (graphs,))
        for cache in peers:
            if key not in cache:
                cache[key] = ChunkGraph(make_body(), ps, k_total)
    return graphs[key].replay(ps, iter0)
