"""CUDA graph replay of the serving request.

The serving body (evaluation/pipeline.py::make_eval_body) is static in
shape and, on the card, free of host syncs, so each of its stages is
captured once per input signature and replayed by graph launches.
:data:`STAGES` lists them, and :func:`serving_stages` says which of them a
configuration replays; this module alone decides that.

- :class:`CudaGraphed` replays a function of (nested) tensors as captured
  graphs, one set per input signature; its inputs that are already a
  graph's static buffers (a stage's outputs passed to the next) are read
  in place.  A capture can be cut at the forwards of given modules: each
  such forward replays as a graph of its own inside a call of that module,
  so that hooks on the module (a profiler range around each KPConv, as
  benchmark/harness/tracing.py::scopes sets) bracket its kernels as they
  do eagerly.
- :class:`GraphSet` holds one body's stages, captured into one memory
  pool; :meth:`GraphSet.bound` makes a method replay its stage inside a
  block, so that a module's own forward hooks still fire once a request
  around its work.
"""

from __future__ import annotations

import contextlib
import gc
import warnings

import torch

from cofii2p_tpu_torch.ops.cuda_lib import graph_nodes
from cofii2p_tpu_torch.utils.profiling import counter, span

# the serving body's stages, in the order a request runs them: sample
# prep, the point branch (KPConvFPN.forward, cut at each KPConv), the rest
# of the network (CoFiI2P.heads), fine matching and RANSAC
STAGES = ("prep", "pc_encoder", "network", "fine_match", "ransac")

_side_streams: dict = {}  # device -> the stream every capture runs on


def serving_stages(cfg) -> tuple:
    """The stages a serving body replays on the card under ``cfg``: all of
    them, but prep under ``kpconv_impl='gather'``, whose k-NN maps
    (ops/knn.py::_take_lowest's ``nonzero``) wait for the card."""
    return tuple(s for s in STAGES if not (s == "prep" and cfg.kpconv_impl == "gather"))


def stage_prefix(stage: str) -> str:
    """The spans and counters of a stage: ``cofii2p.graph.<stage>``, and
    ``cofii2p.ransac`` for RANSAC."""
    return "cofii2p.ransac" if stage == "ransac" else f"cofii2p.graph.{stage}"


def _flatten(tree, leaves: list):
    """Appends the tensors of ``tree`` to ``leaves`` depth first; returns
    its structure, with the other leaves (None, strings, numbers) in it."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return torch.Tensor
    if isinstance(tree, dict):
        return dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree), tuple(_flatten(v, leaves) for v in tree)
    return tree


def _map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _static(t: torch.Tensor) -> torch.Tensor:
    """A capture's buffer for input ``t``: ``t`` itself where it is a
    graph's static buffer, else a copy."""
    return t if getattr(t, "_graph_static", False) else t.clone()


def _side_stream(device):
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


@contextlib.contextmanager
def _forward_replaced(module, fn):
    """``module``'s forward is ``fn`` inside the block (an instance
    attribute over the class's, as torch.cuda.make_graphed_callables sets
    it)."""
    module.forward = fn
    try:
        yield
    finally:
        del module.forward


class _Capture:
    """One capture cut into parts: ``parts`` holds (module or None, graph),
    the module's where the part is that module's forward."""

    def __init__(self, pool):
        self.pool, self.parts, self.open = pool, [], None

    def begin(self, module=None):
        # keep_graph: a part stays readable for its node count, and is
        # instantiated after; thread_local: a loader's threads may call
        # CUDA meanwhile
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.open = (module, graph)

    def end(self):
        module, graph = self.open
        self.open = None
        with warnings.catch_warnings():  # a part between two cut modules may hold no work
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            graph.capture_end()
        self.parts.append((module, graph))

    def abandon(self):
        """Ends a capture that raised, so the stream leaves capture mode."""
        if self.open is not None:
            with contextlib.suppress(RuntimeError):
                self.end()

    def hooks(self, modules) -> list:
        """Hooks that cut the capture at each forward of ``modules``."""
        def enter(module, args):
            self.end()
            self.begin(module)

        def leave(module, args, out):
            self.end()
            self.begin()

        return [h for m in modules for h in (m.register_forward_pre_hook(enter), m.register_forward_hook(leave))]


class CudaGraphed:
    """Replays ``fn`` as captured CUDA graphs, one set per input signature.

    ``fn`` takes tensors, or lists, tuples and dicts of them (None, strings
    and numbers among them belong to the signature), and returns the same.
    A call copies each input tensor into the graph's static buffer unless
    it already is that buffer, replays, and returns the graph's static
    outputs, valid until the next replay writes them.  The first call of a
    signature runs ``fn`` once eagerly on a side stream (builds, caches,
    library handles) and then captures it, into the memory pool that
    ``pool()`` gives where ``pool`` is given (else a pool of its own); a
    capture that fails (``fn`` synchronises the host somewhere)
    raises.  With ``split_at``, the capture is cut at each forward of those
    modules, and a replay runs that part inside a call of the module (with
    no arguments: its hooks fire, its forward replays the part).

    Spans ``<prefix>`` (copies in and replay) and ``<prefix>.replay``;
    counters ``<prefix>.graph_nodes`` and ``<prefix>.captures``
    (:func:`count_nodes`).
    """

    def __init__(self, fn, prefix: str, pool=None, split_at=()):
        self.fn, self.prefix, self.pool, self.split_at = fn, prefix, pool, tuple(split_at)
        self.graphs = {}

    def __call__(self, *args):
        with span(self.prefix):
            leaves = []
            key = (_flatten(args, leaves), tuple((t.shape, t.stride(), t.dtype, t.device) for t in leaves))
            if key not in self.graphs:
                self.graphs[key] = self._capture(args)
            parts, static_in, static_out = self.graphs[key]
            for dst, src in zip(static_in, leaves):
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
            with span(self.prefix + ".replay"):
                for module, graph in parts:
                    if module is None:
                        graph.replay()
                    else:
                        with _forward_replaced(module, graph.replay):
                            module()
            return static_out

    def _capture(self, args):
        static_args = _map(_static, args)
        static_in = []
        _flatten(static_args, static_in)
        device = static_in[0].device
        side = _side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        capture = _Capture(self.pool() if self.pool is not None else torch.cuda.graph_pool_handle())
        with torch.cuda.stream(side):
            self.fn(*static_args)  # warm-up outside the capture
            # as torch.cuda.graph does before a capture: the memory that dead
            # graphs and the warm-up left cached goes back to the card
            torch.cuda.synchronize(device)
            gc.collect()
            torch.cuda.empty_cache()
            handles = capture.hooks(self.split_at)
            try:
                capture.begin()
                static_out = self.fn(*static_args)
                capture.end()
            except BaseException as e:
                capture.abandon()
                if isinstance(e, RuntimeError):
                    raise RuntimeError(f"{self.prefix}: CUDA graph capture failed: {e}") from e
                raise
            finally:
                for h in handles:
                    h.remove()
        torch.cuda.current_stream(device).wait_stream(side)
        parts = count_nodes(capture.parts, self.prefix)
        for _, graph in parts:
            graph.instantiate()
        out = []
        _flatten(static_out, out)
        for t in static_in + out:
            t._graph_static = True
        return parts, static_in, static_out


def count_nodes(parts: list, prefix: str) -> list:
    """Adds a capture's nodes (over its parts) to ``<prefix>.graph_nodes``
    and one to ``<prefix>.captures``, so that their ratio is a capture's
    nodes whatever shapes were captured; returns the parts that hold
    nodes.  The count is a diagnostic: where libcuda's cuGraphGetNodes
    cannot give it, every part serves uncounted and the counters stay as
    they were."""
    try:
        nodes = [graph_nodes(graph) for _, graph in parts]
    except Exception:  # a missing or refusing libcuda entry point
        return parts
    counter(prefix + ".graph_nodes").add(sum(nodes))
    counter(prefix + ".captures").add()
    return [p for p, n in zip(parts, nodes) if n or p[0] is not None]


class GraphSet:
    """The graphs of one serving body: a :class:`CudaGraphed` for each
    stage it replays (``stages``, a subset of :data:`STAGES`), all
    captured into one memory pool (a stage's intermediates reuse the memory
    of those captured before it, as they would eagerly).  A set with no
    stages runs everything eagerly."""

    def __init__(self, stages=STAGES):
        unknown = set(stages) - set(STAGES)
        if unknown:
            raise ValueError(f"no serving stage {sorted(unknown)}; the stages are {STAGES}")
        self.names = tuple(stages)
        self.stages = {}
        self._pool = None

    def stage(self, name: str, fn, split_at=()):
        """Stage ``name``'s graphs of ``fn`` (made on the first call), or
        ``fn`` itself where the set does not replay ``name``."""
        if name not in self.names:
            return fn
        if name not in self.stages:
            self.stages[name] = CudaGraphed(fn, stage_prefix(name), self.pool, split_at)
        return self.stages[name]

    def pool(self):
        """The set's memory pool, made at its first capture."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @contextlib.contextmanager
    def bound(self, obj, attr: str, name: str, split_at=()):
        """Inside the block ``obj.<attr>`` (a method) replays stage
        ``name``'s graphs of what it was, where the set replays ``name``."""
        fn = getattr(obj, attr)
        graphed = self.stage(name, fn, split_at)
        if graphed is fn:
            yield
            return
        setattr(obj, attr, graphed)
        try:
            yield
        finally:
            delattr(obj, attr)
