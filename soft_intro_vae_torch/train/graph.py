"""K train steps a call (``scan_steps > 1``): the port's counterpart of the
JAX package's ``jax.lax.scan`` over K reference-exact steps in one program
(soft_intro_vae_tpu/train/step.py:377-389).

``k_steps(step)`` turns a one-batch step into ``step(state, xs) -> (state,
metrics)`` over ``xs`` of shape (K, B, ...), each metric a (K,) tensor under
the one-batch step's names, as the JAX scan returns them. On the CPU it runs
the K steps eagerly. On the card it always runs a CUDA graph and raises when
capture fails; it never falls back to eager steps.

The graph holds one step, captured once per (batch shape, dtype) and
replayed once a step, so a trailing chunk of k < K batches replays it k
times and capture costs one step whatever K is. Each replay reads its batch
from a static buffer (a device-to-device copy before the replay, on the
caller's stream) and leaves its metrics in a static row, copied into column
i of the (M, K) result after the replay. The first call of a graph runs
``WARMUP_STEPS`` eager steps on a side stream first (cuDNN and cuBLAS
handles and workspaces, Adam's lazy state): they are real steps of the run,
the first of its chunk, and their metrics are the chunk's first columns.

What a replay does not run: the step's host code. ``requires_grad`` toggles
and ``train()`` are fixed at capture (each step ends in the state the next
one starts from), and ``state.step`` is advanced here, by the replays made.
Random draws come from ``state.generator``, registered with the graph, so a
replay draws what the eager step would (the generator's offset advances by a
whole step a replay). Gradients are allocated inside the capture from the
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
cannot be captured: under gloo a K-step call runs K eager steps, as on the
CPU, and says so once.
"""

from __future__ import annotations

import collections
import warnings
from typing import Callable, Dict, Tuple

import torch

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


class GraphedStep:
    """One step captured as a CUDA graph, replayed once a batch (module doc)."""

    def __init__(self, step: Callable):
        self.step = step
        self.state = None
        self.stream = None
        self.graphs: Dict[Tuple, Tuple] = {}

    def __call__(self, state, xs: torch.Tensor):
        if not xs.is_cuda:
            raise ValueError(f"a graphed step takes batches on the card, got {xs.device}")
        if self.state is None:
            self.state = state
        elif state is not self.state:
            raise ValueError("this step's graph was captured for another TrainState; "
                             "build the steps again for a new state")
        k = xs.shape[0]
        cur = torch.cuda.current_stream(xs.device)
        key = (tuple(xs.shape[1:]), xs.dtype)
        done = []
        if key not in self.graphs:
            done = self._warm_up(state, xs, cur)
            names = list(done[0][1])
        else:
            names = self.graphs[key][3]
        out = torch.empty((len(names), k), dtype=torch.float32, device=xs.device)
        for i, (row, _) in enumerate(done):
            out[:, i].copy_(row)
        if key not in self.graphs:
            self.graphs[key] = self._capture(state, xs, names)
        graph, x_static, row_static, _, per_replay = self.graphs[key]
        for i in range(len(done), k):
            x_static.copy_(xs[i])
            graph.replay()
            out[:, i].copy_(row_static)
            replayed.update(per_replay)
        state.step += k - len(done)  # the warm-up steps advanced it themselves
        return state, dict(zip(names, out))

    def _warm_up(self, state, xs, cur):
        """Eager steps on the side stream on the first batches of ``xs``."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(xs.device)
        done = []
        x = torch.empty_like(xs[0])
        for i in range(min(WARMUP_STEPS, xs.shape[0])):
            x.copy_(xs[i])
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                _, m = self.step(state, x)
                done.append((_stack(m, list(m)), m))
            cur.wait_stream(self.stream)
        return done

    def _capture(self, state, xs, names):
        x_static = torch.empty_like(xs[0])
        x_static.copy_(xs[0])  # any batch: capture records, it computes nothing
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        before, step = wrapper_counts(), state.step
        # thread_local: the prefetch worker keeps copying batches meanwhile
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
            _, m = self.step(state, x_static)
            row_static = _stack(m, names)
        state.step = step  # the captured step runs on replay
        global captures
        captures += 1
        per_replay = collections.Counter(
            {k: v - before[k] for k, v in wrapper_counts().items() if v != before[k]})
        captured.update(per_replay)
        return graph, x_static, row_static, names, per_replay


def k_steps(step: Callable) -> Callable:
    """``step(state, x)`` -> ``step(state, xs)`` over the K batches of
    ``xs`` (module doc): a CUDA graph on the card, K eager steps on the CPU."""
    graphed = GraphedStep(step)
    said = []

    def run(state, xs: torch.Tensor):
        if xs.dim() < 2 or xs.shape[0] < 1:
            raise ValueError(f"a K-step takes (K, B, ...) batches, K >= 1; got {tuple(xs.shape)}")
        if xs.is_cuda and current_world().backend == "gloo":
            if not said:
                said.append(True)
                warnings.warn("gloo collectives cannot be captured in a CUDA graph: each K-step "
                              "call runs K eager steps", stacklevel=2)
        elif xs.is_cuda:
            return graphed(state, xs)
        rows = []
        for x in xs:
            state, m = step(state, x)
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    return run
