"""CUDA graphs of the scanned epoch's steps: one graph per stacked shape
group, captured once and replayed once per bag.

The counterpart of the JAX package's ``lax.scan`` over a stacked group
(``acmil_tpu/engine/train.py::make_scan_train_step``): there one dispatch
runs the whole group; here one capture records the step of one bag, whose
index a static device tensor holds (``jnp.take(leaf, i, axis=0)``), and each
bag of the visit order is one replay after that index is written. The
graphs of all groups, train and eval, share one memory pool: they replay one
at a time, and nothing a graph leaves in the pool is read after another
graph has run (the aux sums and the eval probabilities live outside it).

The kernels' wrappers count a launch where they are called, and a capture
calls them without launching anything; :class:`GraphSteps` puts the
counters back after each capture, keeps what one replay launches, and
counts its replays, so :meth:`GraphSteps.kernel_launches` is launches per
capture times replays. Each graph gives those counters to the span
registry (``utils/profiling.py::counter_source``), and its warm-up, its
captures and its replays are spans there (``graph.warm``,
``graph.capture``, ``graph.replay``, the last device-timed).
"""

from __future__ import annotations

import functools
import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from acmil_tpu_torch.data.bags import Bag
from acmil_tpu_torch.utils import profiling


def launch_counters() -> Dict[str, object]:
    """The kernel wrappers whose ``launches`` attribute counts the launches
    of kernels B1, B2 and B6, by kernel name."""
    from acmil_tpu_torch.ops import attn_pool, dsmil_pool

    return {"B1": attn_pool.fused_gated_attn_pool_batched,
            "B2": attn_pool.fused_gated_attn_pool_bwd,
            "B6": dsmil_pool.fused_dsmil_pool}


def take(stacked: Bag, idx: torch.Tensor) -> Bag:
    """Bag ``idx`` ([1] int64 on the group's device) of a stacked group, as a
    copy: the same op eagerly and inside a graph."""
    return Bag(*(t.index_select(0, idx).squeeze(0) for t in stacked._fields()))


class GraphSteps:
    """Graphs of ``fn(bag)`` keyed by stacked group, captured on first use.

    ``fn`` runs the step of one bag; ``record(stacked, outputs, idx)`` runs
    inside the graph after it, writing what must survive the replay into
    tensors the caller allocated outside the pool. ``warm(groups)`` runs
    before the first capture, eagerly and on a side stream: it builds the
    kernels, sets their attributes and initialises the optimizer's state,
    and must leave every state it changes as it found it. ``generators`` are
    registered with every graph, so replays draw the sequence that eager
    steps draw from them; torch's default CUDA generator takes part by
    itself. A capture that fails raises."""

    def __init__(self, fn: Callable[[Bag], object],
                 record: Callable[[Bag, object, torch.Tensor], None],
                 device: torch.device,
                 generators: List[torch.Generator] = (),
                 warm: Optional[Callable[[List[Bag]], None]] = None):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        if generators and not hasattr(torch.cuda.CUDAGraph,
                                      "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} has no "
                f"CUDAGraph.register_generator_state: the step's draws from "
                f"its own generator cannot be captured")
        self.fn, self.record, self.device = fn, record, device
        self.generators = list(generators)
        self.warm = warm
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[int, tuple] = {}
        # per group: what one replay launches, its replays, capture seconds
        # and what the shared pool grew by at its capture
        self.per_replay: Dict[int, Dict[str, int]] = {}
        self.replays: Dict[int, int] = {}
        self.capture_s: Dict[int, float] = {}
        self.pool_bytes: Dict[int, int] = {}
        profiling.counter_source(functools.partial(
            _counters, self.capture_s, self.replays, self.pool_bytes,
            self.per_replay))

    @staticmethod
    def key(stacked: Bag) -> int:
        return stacked.feats.data_ptr()

    def prepare(self, groups: List[Bag]) -> None:
        """Warm up, then capture, every group of ``groups`` that has no
        graph yet: all warm-ups come before the first capture."""
        new = [g for g in groups if self.key(g) not in self._graphs]
        if not new:
            return
        if self.warm is not None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side), profiling.span("graph.warm"):
                self.warm(new)
            torch.cuda.current_stream(self.device).wait_stream(side)
        for stacked in new:
            with profiling.span("graph.capture"):
                self._capture(stacked)

    def _capture(self, stacked: Bag) -> None:
        counters = launch_counters()
        before = {k: f.launches for k, f in counters.items()}
        idx = torch.zeros(1, dtype=torch.int64, device=self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        torch.cuda.synchronize(self.device)
        # torch.cuda.graph empties the cache before it captures: so do we,
        # and the growth of reserved memory is what the pool took anew
        torch.cuda.empty_cache()
        used0 = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        # no cyclic garbage collection inside the capture (torch.cuda.graph
        # collects before it begins): a collected object's CUDA resources
        # freed mid-capture would invalidate it; other threads (a loader's
        # prefetch) may call the runtime meanwhile
        gc_was = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                self.record(stacked, self.fn(take(stacked, idx)), idx)
        finally:
            if gc_was:
                gc.enable()
        torch.cuda.synchronize(self.device)
        key = self.key(stacked)
        self.capture_s[key] = time.perf_counter() - t0
        self.pool_bytes[key] = torch.cuda.memory_reserved(self.device) - used0
        # nothing ran: the capture's calls of the wrappers are not launches
        self.per_replay[key] = {k: f.launches - before[k]
                                for k, f in counters.items()}
        for k, f in counters.items():
            f.launches = before[k]
        self.replays[key] = 0
        self._graphs[key] = (graph, idx)

    def replay(self, stacked: Bag, i: int) -> None:
        """One replay of ``stacked``'s graph on its bag ``i``."""
        key = self.key(stacked)
        graph, idx = self._graphs[key]
        with profiling.span("graph.replay", device=True):
            idx.fill_(int(i))
            graph.replay()
        self.replays[key] += 1

    def kernel_launches(self) -> Dict[str, int]:
        """Launches of each kernel the replays made so far."""
        return _launches(self.per_replay, self.replays)


def _launches(per_replay, replays) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for key, per in per_replay.items():
        for name, n in per.items():
            out[name] = out.get(name, 0) + n * replays[key]
    return out


def _counters(capture_s, replays, pool_bytes, per_replay) -> Dict[str, float]:
    """A :class:`GraphSteps`' totals as the span registry reads them, from
    its dicts, which outlive it there: capture seconds, replays, the pool's
    growth at capture and the replays' kernel launches."""
    out = {"graph.capture_s": sum(capture_s.values()),
           "graph.replays": sum(replays.values()),
           "graph.pool_bytes": sum(pool_bytes.values())}
    out.update((f"graph.launches.{k}", n)
               for k, n in _launches(per_replay, replays).items())
    return out
