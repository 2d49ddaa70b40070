"""Train steps replayed as CUDA graphs: the port's counterpart of the JAX
package's compiled step programs.

``one_step(step)`` keeps the step's own signature, ``step(state, x,
*scalars[, draws])``, and returns 0-dim metrics: the counterpart of the JAX
package's jitted donated-buffer step, the generic step at ``scan_steps == 1``
(soft_intro_vae_tpu/train/step.py:390-393; the image, bootstrap, 3D and toy
trainers) and the style step per (lod, in_transition)
(soft_intro_vae_tpu/train/style_step.py:342-345), whose blend is a float32
0-dim input. ``k_steps(step)`` is ``step(state, xs) -> (state, metrics)``
over ``xs`` of shape (K, B, ...): K calls of ``one_step(step)``, each metric
stacked to a (K,) tensor under the one-batch step's names, as the JAX
package's ``jax.lax.scan`` over K steps returns them
(soft_intro_vae_tpu/train/step.py:377-389). On the CPU a call runs the step
eagerly. On the card it always runs a CUDA graph and raises when capture
fails; it never falls back to eager steps.

A graph holds one step, captured once per key after ``WARMUP_STEPS`` eager
steps of that key, one a call, and replayed once a call. The key is what a
``jax.jit`` step retraces on: the batch's shape and dtype, the number of
scalar inputs, and the names, shapes and dtypes of the injected draws
(``step_key``). Each replay reads its batch from a static buffer, each 0-dim
scalar input (the style step's blend) from a static slot, and each injected
draw (the generic step's ``noises``, the style step's ``nz``: the JAX
package's golden-value hook) from a static tensor of its shape
(device-to-device copies or fills before the replay, on the caller's
stream); without draws the step draws from ``state.generator``. It leaves
its metrics in a static row, copied after the replay: every call returns
metrics of its own, which later replays do not overwrite. The warm-up steps
run on a side stream (cuDNN and cuBLAS handles and workspaces, Adam's lazy
state, the kernels' libraries); they are real steps of the run and return
their own metrics.

What a replay does not run: the step's host code. ``requires_grad`` toggles
and ``train()`` are fixed at capture (each step ends in the state the next
one starts from), and ``state.step`` is advanced here, one a replay. Random
draws come from ``state.generator``, registered with the graph, so a replay
draws what the eager step would (the generator's offset advances by a whole
step a replay); a checkpointed forward that draws from it recomputes from
clones of its state registered with the graph (models/remat.py
``Restarts``). Gradients are allocated inside the capture from the graph's
private pool, as in PyTorch's whole-network capture, and the captured
optimizer steps read them. The LR is read from the optimizer's LR tensor
(train/optim.py), so ``set_lr`` between calls takes effect.

A graph reads and writes the state's own tensors: parameters, BN buffers and
Adam's moments and counts, updated in place. The states' ``load_state_dict``
copies a checkpoint into those tensors (train/optim.py ``load_state_dict``
into the moments and counts the optimizer holds), so a checkpoint loaded
between calls is what the next replay reads; whatever replaces one of them
(a new state) leaves the graph stale: build new steps for a new state.

Data parallelism (parallel/mesh.py): under NCCL the step's collectives (the
gradient reduces, the BatchNorms' reduces, the metrics' reduce) are issued
on the side stream in the warm-up steps, which start NCCL's communicator,
and are captured with the rest of the step, so a replay runs them too. gloo
cannot be captured: under gloo a call runs one eager step, as on the CPU,
and says so once.

Spans (utils/profiling.py): each eager warm-up step is a ``graph.warmup``,
each capture a ``graph.capture``, and each replay, from the static input's
copy to the metrics row's, a ``graph.replay``.

Launch counts: a hand-written kernel's wrapper counts each call in
ops/cuda_build.py ``launches``, a call recorded into a capture included; a
replay launches the recorded kernels again without calling the wrappers, so
``captured`` and ``replayed`` count those here, by kernel. Launches on the
device = wrapper count - captured + replayed.

A graph and its private memory pool live as long as its ``GraphedStep``:
the style trainer drops a LOD's steps when ``LODDriver`` moves on, and the
image, 3D and toy trainers drop the vanilla step at the switch to the
introspective one.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from soft_intro_vae_torch.models import remat
from soft_intro_vae_torch.ops.cuda_build import launches
from soft_intro_vae_torch.parallel import collectives
from soft_intro_vae_torch.parallel.mesh import current_world
from soft_intro_vae_torch.utils.profiling import span

WARMUP_STEPS = 3

# Kernel launches that captures recorded and that replays made, by kernel
# (module doc)
captured: collections.Counter = collections.Counter()
replayed: collections.Counter = collections.Counter()
# CUDA graphs captured so far, every step's together: work between calls (an
# FID evaluation) must leave the graphs as they are and force none anew
captures = 0


def wrapper_counts() -> collections.Counter:
    """Each hand-written kernel's wrapper calls (ops/cuda_build.py
    ``launches``), and each kind of collective's (``nccl_<kind>``,
    parallel/collectives.py)."""
    counts = collections.Counter(launches)
    counts.update({f"nccl_{k}": collectives.calls[k] for k in collectives.KINDS})
    return counts


def _stack(metrics: Dict[str, torch.Tensor], names) -> torch.Tensor:
    return torch.stack([metrics[n].float() for n in names])


def step_key(x: torch.Tensor, scalars: Sequence = (),
             draws: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple:
    """A graph's key for a call on the batch ``x`` with ``scalars`` and
    ``draws`` (name -> tensor): the batch's shape and dtype, how many
    scalars, and each draw's name, shape and dtype."""
    named = tuple(sorted((n, tuple(v.shape), v.dtype) for n, v in (draws or {}).items()))
    return tuple(x.shape), x.dtype, len(scalars), named


def _args(scalars, draws) -> list:
    """The step's arguments after the batch: its scalars, then its draws
    where there are any."""
    return [*scalars, draws] if draws else list(scalars)


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor                  # the static batch
    slots: List[torch.Tensor]        # the static 0-dim scalar inputs
    draws: Dict[str, torch.Tensor]   # the static injected draws
    row: torch.Tensor                # the static metrics row
    per_replay: collections.Counter  # kernel launches recorded in the capture
    restarts: Sequence[torch.Generator]  # remat clones of the generator's state
    offsets: List[int]               # and each one's offset from the step's start


class GraphedStep:
    """One step captured as a CUDA graph, replayed once a call (module doc)."""

    def __init__(self, step: Callable):
        self.step = step
        self.state = None
        self.stream = None
        self.graphs: Dict[Tuple, _Graph] = {}
        self.warmed: collections.Counter = collections.Counter()  # warm-up steps by key
        self.offsets: Dict[Tuple, List[int]] = {}  # remat restarts seen in warm-up, by key
        self.names: Dict[Tuple, List[str]] = {}  # the step's metric names, by key

    def __call__(self, state, x: torch.Tensor, *scalars,
                 draws: Optional[Dict[str, torch.Tensor]] = None):
        """One step on the batch ``x`` on the card; each of ``scalars`` a
        float or a float32 0-dim tensor on the card; ``draws``, injected
        draws by name, each a tensor of the step's own shape on the card."""
        if not x.is_cuda:
            raise ValueError(f"a graphed step takes batches on the card, got {x.device}")
        if self.state is None:
            self.state = state
        elif state is not self.state:
            raise ValueError("this step's graph was captured for another TrainState; "
                             "build the steps again for a new state")
        draws = draws or {}
        key = step_key(x, scalars, draws)
        if key not in self.graphs and self.warmed[key] < WARMUP_STEPS:
            with span("graph.warmup"):
                row = self._warm_up(state, key, x, scalars, draws).clone()
            return state, dict(zip(self.names[key], row))
        if key not in self.graphs:
            with span("graph.capture"):
                self.graphs[key] = self._capture(state, key, x, scalars, draws)
        g = self.graphs[key]
        with span("graph.replay"):
            g.x.copy_(x)
            for slot, s in zip(g.slots, scalars):
                _write(slot, s)
            for n, slot in g.draws.items():
                slot.copy_(draws[n])
            _restart_from(state.generator, g.restarts, g.offsets)
            g.graph.replay()
            row = g.row.clone()
        replayed.update(g.per_replay)
        state.step += 1  # a warm-up step advances it itself
        return state, dict(zip(self.names[key], row))

    def _warm_up(self, state, key, x, scalars, draws):
        """One eager step on the side stream: its metrics row."""
        cur = torch.cuda.current_stream(x.device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(x.device)
        x_side = torch.empty_like(x)
        x_side.copy_(x)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream), remat.recording(state.generator) as r:
            _, m = self.step(state, x_side, *_args(scalars, draws))
            self.names[key] = list(m)
            row = _stack(m, self.names[key])
        cur.wait_stream(self.stream)
        self.warmed[key] += 1
        self.offsets[key] = r.offsets
        return row

    def _capture(self, state, key, x, scalars, draws):
        x_static = torch.empty_like(x)
        x_static.copy_(x)  # any batch: capture records, it computes nothing
        slots = [torch.empty((), dtype=torch.float32, device=x.device) for _ in scalars]
        for slot, s in zip(slots, scalars):
            _write(slot, s)
        draws_static = {n: v.clone() for n, v in draws.items()}
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        offsets = self.offsets[key]
        restarts = [state.generator.clone_state() for _ in offsets]
        for r in restarts:
            graph.register_generator_state(r)
        before, step = wrapper_counts(), state.step
        # thread_local: the prefetch worker keeps copying batches meanwhile
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"), \
                remat.capturing(restarts):
            _, m = self.step(state, x_static, *_args(slots, draws_static))
            row_static = _stack(m, self.names[key])
        state.step = step  # the captured step runs on replay
        global captures
        captures += 1
        per_replay = collections.Counter(
            {k: v - before[k] for k, v in wrapper_counts().items() if v != before[k]})
        captured.update(per_replay)
        return _Graph(graph, x_static, slots, draws_static, row_static, per_replay, restarts,
                      offsets)


def _write(slot: torch.Tensor, value) -> None:
    if isinstance(value, torch.Tensor):
        slot.copy_(value)
    else:
        slot.fill_(float(value))


def _restart_from(generator: torch.Generator, restarts, offsets) -> None:
    """Each remat clone at the generator's seed and offset plus its call's
    offset from the step's start, for the next replay (models/remat.py)."""
    if not restarts:
        return
    seed, base = generator.initial_seed(), generator.get_offset()
    for r, offset in zip(restarts, offsets):
        r.manual_seed(seed)
        r.set_offset(base + offset)


def _eager_on(x: torch.Tensor, said: list, what: str) -> bool:
    """True where a graphed step runs eagerly: CPU tensors, and gloo (which
    cannot be captured; warned once)."""
    if not x.is_cuda:
        return True
    if current_world().backend != "gloo":
        return False
    if not said:
        said.append(True)
        warnings.warn(f"gloo collectives cannot be captured in a CUDA graph: {what}",
                      stacklevel=3)
    return True


def k_steps(step: Callable) -> Callable:
    """``step(state, x)`` -> ``step(state, xs)`` over the K batches of
    ``xs`` (K, B, ...): K calls of ``one_step(step)``, each metric stacked
    to (K,) (module doc)."""
    single = one_step(step)

    def run(state, xs: torch.Tensor):
        if xs.dim() < 2 or xs.shape[0] < 1:
            raise ValueError(f"a K-step takes (K, B, ...) batches, K >= 1; got {tuple(xs.shape)}")
        rows = []
        for x in xs:
            state, m = single(state, x)
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    return run


def one_step(step: Callable) -> Callable:
    """``step(state, x, *scalars[, draws])`` replayed as a CUDA graph a call
    on the card (module doc): one capture per ``step_key`` after
    ``WARMUP_STEPS`` eager steps; each scalar (the style step's blend: a
    float, or a float32 0-dim tensor on the card) written into the graph's
    slot, and ``draws``, the last argument where it is a mapping (the steps'
    injected draws by name, arrays or tensors), copied into the graph's own
    tensors; eager on the CPU and under gloo. Returns 0-dim metrics of the
    call's own. ``.eager`` is ``step``, ``.graphed`` its ``GraphedStep``."""
    graphed = GraphedStep(step)
    said = []
    name = getattr(step, "__name__", "step")

    def run(state, x: torch.Tensor, *args):
        if _eager_on(x, said, f"each {name} call runs eagerly"):
            return step(state, x, *args)
        draws = None
        if args and (args[-1] is None or isinstance(args[-1], Mapping)):
            args, draws = args[:-1], args[-1]
        draws = {n: torch.as_tensor(v, device=x.device) for n, v in (draws or {}).items()}
        return graphed(state, x, *args, draws=draws)

    run.eager = step
    run.graphed = graphed
    return run
