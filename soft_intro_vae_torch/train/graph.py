"""Train steps replayed as CUDA graphs: the port's counterpart of the JAX
package's compiled step programs.

  * ``k_steps``: K train steps a call (``scan_steps > 1``), the counterpart
    of the JAX package's ``jax.lax.scan`` over K reference-exact steps in one
    program (soft_intro_vae_tpu/train/step.py:377-389);
  * ``one_step``: one step a call, the counterpart of the JAX package's
    jitted donated-buffer step: the generic step at ``scan_steps == 1``
    (soft_intro_vae_tpu/train/step.py:390-393; the image, bootstrap, 3D and
    toy trainers) and the style step per (lod, in_transition)
    (soft_intro_vae_tpu/train/style_step.py:342-345), whose blend is a
    float32 0-dim input.

``k_steps(step)`` turns a one-batch step into ``step(state, xs) -> (state,
metrics)`` over ``xs`` of shape (K, B, ...), each metric a (K,) tensor under
the one-batch step's names, as the JAX scan returns them. ``one_step(step)``
keeps the step's own signature, ``step(state, x, *scalars[, draws])``, and
returns 0-dim metrics. On the CPU both run the steps eagerly. On the card
they always run a CUDA graph and raise when capture fails; they never fall
back to eager steps.

The graph holds one step, captured once per key and replayed once a step,
so a trailing chunk of k < K batches replays it k times and capture costs
one step whatever K is. The key is what a ``jax.jit`` step retraces on: the
batch's shape and dtype, the number of scalar inputs, and the names, shapes
and dtypes of the injected draws (``step_key``). Each replay reads its batch
from a static buffer, each 0-dim scalar input (the style step's blend) from
a static slot, and each injected draw (the generic step's ``noises``, the
style step's ``nz``: the JAX package's golden-value hook) from a static
tensor of its shape (device-to-device copies or fills before the replay, on
the caller's stream); without draws the step draws from ``state.generator``.
It leaves its metrics in a static row, copied into column i of the (M, K)
result after the replay: every call returns metrics of its own, which later
replays do not overwrite. Before its capture a graph
runs ``WARMUP_STEPS`` eager steps on a side stream, over one call or several
(cuDNN and cuBLAS handles and workspaces, Adam's lazy state, the fused
norm's libraries): they are real steps of the run, and their metrics are
their calls' columns.

What a replay does not run: the step's host code. ``requires_grad`` toggles
and ``train()`` are fixed at capture (each step ends in the state the next
one starts from), and ``state.step`` is advanced here, by the replays made.
Random draws come from ``state.generator``, registered with the graph, so a
replay draws what the eager step would (the generator's offset advances by a
whole step a replay); a checkpointed forward that draws from it recomputes
from clones of its state registered with the graph (models/remat.py
``Restarts``). Gradients are allocated inside the capture from the
graph's private pool, as in PyTorch's whole-network capture, and the captured
optimizer steps read them. The LR is read from the optimizer's LR tensor
(train/optim.py), so ``set_lr`` between calls takes effect.

A graph reads and writes the state's own tensors: parameters, BN buffers and
Adam's moments and counts, updated in place. Whatever replaces one of them
(``load_state_dict`` of an optimizer, a new state) leaves the graph stale;
load checkpoints before the first call, and build new steps for a new state.

Data parallelism (parallel/mesh.py): under NCCL the step's collectives (the
gradient reduces, the BatchNorms' reduces, the metrics' reduce) are issued
on the side stream in the warm-up steps, which start NCCL's communicator,
and are captured with the rest of the step, so a replay runs them too. gloo
cannot be captured: under gloo a K-step call runs K eager steps, and a
``one_step`` call one eager step, as on the CPU, and each says so once.

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
from soft_intro_vae_torch.ops import adain_cuda, chamfer_cuda, u8norm_cuda
from soft_intro_vae_torch.parallel import collectives
from soft_intro_vae_torch.parallel.mesh import current_world

WARMUP_STEPS = 3

# Kernel launches of the hand-written kernels under graphs, by kernel: a
# wrapper called during a capture records its kernel into the graph (and
# counts that call in its own ``launches``); each replay launches it again
# without calling the wrapper. ``captured`` counts the recorded launches,
# ``replayed`` the launches that replays made. Launches on the device =
# wrapper count - captured + replayed.
captured: collections.Counter = collections.Counter()
replayed: collections.Counter = collections.Counter()
# CUDA graphs captured so far, every step's together: work between calls (an
# FID evaluation) must leave the graphs as they are and force none anew
captures = 0


def wrapper_counts() -> Dict[str, int]:
    """Each hand-written kernel's wrapper count (ops/*_cuda.py ``launches``),
    and each kind of collective's (``nccl_<kind>``, parallel/collectives.py)."""
    counts = {"chamfer_nearest": chamfer_cuda.launches,
              "bias_act_norm_fwd": adain_cuda.launches_fwd,
              "bias_act_norm_bwd": adain_cuda.launches_bwd, "u8norm": u8norm_cuda.launches}
    counts.update({f"nccl_{k}": collectives.calls[k] for k in collectives.KINDS})
    return counts


def _stack(metrics: Dict[str, torch.Tensor], names) -> torch.Tensor:
    return torch.stack([metrics[n].float() for n in names])


def step_key(xs: torch.Tensor, scalars: Sequence = (),
             draws: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple:
    """A graph's key for a call on ``xs`` (K, B, ...) with ``scalars`` and
    ``draws`` (name -> (K, ...) tensor): the batch's shape and dtype, how many
    scalars, and each draw's name, shape and dtype."""
    named = tuple(sorted((n, tuple(v.shape[1:]), v.dtype) for n, v in (draws or {}).items()))
    return tuple(xs.shape[1:]), xs.dtype, len(scalars), named


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
    """One step captured as a CUDA graph, replayed once a batch (module doc)."""

    def __init__(self, step: Callable):
        self.step = step
        self.state = None
        self.stream = None
        self.graphs: Dict[Tuple, _Graph] = {}
        self.warmed: collections.Counter = collections.Counter()  # warm-up steps by key
        self.offsets: Dict[Tuple, List[int]] = {}  # remat restarts seen in warm-up, by key
        self.names: Dict[Tuple, List[str]] = {}  # the step's metric names, by key

    def __call__(self, state, xs: torch.Tensor, *scalars,
                 draws: Optional[Dict[str, torch.Tensor]] = None):
        """``xs`` (K, B, ...) on the card; each of ``scalars`` K values
        (a (K,) float32 tensor on the card, or floats), step i's ``i``-th;
        ``draws``, injected draws by name, each a (K, ...) tensor on the card."""
        if not xs.is_cuda:
            raise ValueError(f"a graphed step takes batches on the card, got {xs.device}")
        if self.state is None:
            self.state = state
        elif state is not self.state:
            raise ValueError("this step's graph was captured for another TrainState; "
                             "build the steps again for a new state")
        k = xs.shape[0]
        draws = draws or {}
        cur = torch.cuda.current_stream(xs.device)
        key = step_key(xs, scalars, draws)

        def inputs(i):  # step i's scalars and draws
            return [s[i] for s in scalars], {n: v[i] for n, v in draws.items()}

        done = []
        while key not in self.graphs and len(done) < k and self.warmed[key] < WARMUP_STEPS:
            done.append(self._warm_up(state, key, xs[len(done)], *inputs(len(done)), cur))
        names = self.names[key]
        out = torch.empty((len(names), k), dtype=torch.float32, device=xs.device)
        for i, row in enumerate(done):
            out[:, i].copy_(row)
        if len(done) < k and key not in self.graphs:
            i = len(done)
            self.graphs[key] = self._capture(state, key, xs[i], *inputs(i), names)
        for i in range(len(done), k):
            g = self.graphs[key]
            g.x.copy_(xs[i])
            for slot, s in zip(g.slots, scalars):
                _write(slot, s[i])
            for n, slot in g.draws.items():
                slot.copy_(draws[n][i])
            _restart_from(state.generator, g.restarts, g.offsets)
            g.graph.replay()
            out[:, i].copy_(g.row)
            replayed.update(g.per_replay)
        state.step += k - len(done)  # the warm-up steps advanced it themselves
        return state, dict(zip(names, out))

    def _warm_up(self, state, key, x_i, scalars, draws, cur):
        """One eager step on the side stream: its metrics row."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(x_i.device)
        x = torch.empty_like(x_i)
        x.copy_(x_i)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream), remat.recording(state.generator) as r:
            _, m = self.step(state, x, *_args(scalars, draws))
            self.names[key] = list(m)
            row = _stack(m, self.names[key])
        cur.wait_stream(self.stream)
        self.warmed[key] += 1
        self.offsets[key] = r.offsets
        return row

    def _capture(self, state, key, x_i, scalars, draws, names):
        x_static = torch.empty_like(x_i)
        x_static.copy_(x_i)  # any batch: capture records, it computes nothing
        slots = [torch.empty((), dtype=torch.float32, device=x_i.device) for _ in scalars]
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
            row_static = _stack(m, names)
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
        slot.fill_(value)


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
    ``xs`` (module doc): a CUDA graph on the card, K eager steps on the CPU."""
    graphed = GraphedStep(step)
    said = []

    def run(state, xs: torch.Tensor):
        if xs.dim() < 2 or xs.shape[0] < 1:
            raise ValueError(f"a K-step takes (K, B, ...) batches, K >= 1; got {tuple(xs.shape)}")
        if not _eager_on(xs, said, "each K-step call runs K eager steps"):
            return graphed(state, xs)
        rows = []
        for x in xs:
            state, m = step(state, x)
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
        scalars = [s.view(1) if isinstance(s, torch.Tensor) else [float(s)] for s in args]
        draws = {n: torch.as_tensor(v, device=x.device)[None] for n, v in (draws or {}).items()}
        state, m = graphed(state, x[None], *scalars, draws=draws)
        return state, {k: v[0] for k, v in m.items()}

    run.eager = step
    run.graphed = graphed
    return run
