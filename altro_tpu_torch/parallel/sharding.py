"""Multi-device scale-out: scenario batches sharded over the ranks of a
``torch.distributed`` process group (the PyTorch counterpart of
``altro_tpu/parallel/sharding.py``).

The scale-out axes are those of the JAX package: the batch axis (thousands
of MPC scenarios per card, the solver's own leading axis) and the device
axis, here one rank per card, each solving its contiguous slice of the
batch. The solver is purely per scenario, so the only cross-rank dataflow
is the fleet's aggregate metrics: an all-reduce SUM of the iteration counts
(and successes) and a MAX of the violation, the JAX package's ``psum`` and
``pmax``, run after the step's CUDA graphs and outside any capture.

A :class:`ScenarioMesh` is the 1-D mesh (axis ``BATCH_AXIS``) of the
current process group: its rank, size and device, ``cuda:<rank>`` (one
card per rank, never shared) unless the CPU is asked for; the backend
follows the device, NCCL on CUDA and gloo on the CPU. :func:`process_group`
initialises a group of ranks at a TCP address on this host and tears it
down; :func:`launch` spawns the ranks, runs functions of the port on each
and gathers their results. Nothing falls back: a group that cannot start,
a missing backend or a failed collective raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..convert import tree_to
from ..mpc import MPCResults, make_mpc_step, make_mpc_step_device_compacted
from ..problem import Problem
from ..solver import graph
from ..solver.options import SolverOptions

BATCH_AXIS = "batch"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# seconds a rank waits for the others at a collective, and :func:`launch`
# for all of its ranks' results
GROUP_TIMEOUT_S, LAUNCH_TIMEOUT_S = 300.0, 1800.0


@dataclass(frozen=True)
class ScenarioMesh:
    """The 1-D scenario mesh (axis ``BATCH_AXIS``) of the default process
    group: rank ``rank`` of ``size`` holds the ``rank``-th contiguous slice
    of every batch, on ``device``."""

    rank: int
    size: int
    device: torch.device

    def bounds(self, batch: int):
        """(lo, hi) of this rank's slice of a batch of ``batch`` lanes."""
        if batch % self.size:
            raise ValueError(f"a batch of {batch} scenarios does not divide "
                             f"over {self.size} ranks")
        per = batch // self.size
        return self.rank * per, (self.rank + 1) * per

    def shard(self, t):
        """This rank's contiguous slice of ``t``'s leading (batch) axis, on
        the mesh's device."""
        t = torch.as_tensor(t)
        lo, hi = self.bounds(t.shape[0])
        return t[lo:hi].to(self.device)

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``t`` reduced over the ranks with ``op`` (a
        ``dist.ReduceOp``), in place; returns it."""
        dist.all_reduce(t, op=op)
        return t


def make_scenario_mesh(n_devices: Optional[int] = None,
                       device_type: str = "cuda") -> ScenarioMesh:
    """The 1-D "batch" mesh of the initialised default process group (the
    counterpart of ``jax.make_mesh((n,), ("batch",))``). ``n_devices``,
    when given, must be the group's size. The device is ``cuda:<rank>``
    (``LOCAL_RANK`` when set), or the CPU for ``device_type="cpu"``; the
    group's backend must be the device's (NCCL on CUDA, gloo on the
    CPU)."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one first "
                           "(parallel.process_group or parallel.launch)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices in a group of "
                         f"{size} ranks")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise RuntimeError(f"a {device_type} mesh needs the "
                           f"{BACKENDS[device_type]} backend, the group runs "
                           f"{backend}")
    if device_type == "cpu":
        return ScenarioMesh(rank, size, torch.device("cpu"))
    local = int(os.environ.get("LOCAL_RANK", rank))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank} needs card {local}, this host has "
                           f"{torch.cuda.device_count()}: no rank shares a "
                           f"card")
    return ScenarioMesh(rank, size, torch.device("cuda", local))


def free_port() -> int:
    """A free TCP port on this host's loopback address."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(rank: int, world_size: int, device_type: str = "cuda",
                  port: Optional[int] = None):
    """Initialise the default process group of ``world_size`` ranks on this
    host (``tcp://127.0.0.1:<port>``; ``port`` None: a free one, which only
    a group of one rank can use) with the device's backend, yield the
    :func:`make_scenario_mesh` of this rank, and destroy the group on
    exit. On CUDA the rank's card becomes the current device first."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if port is None:
        if world_size != 1:
            raise ValueError("a group of several ranks needs a shared port")
        port = free_port()
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        BACKENDS[device_type], init_method=f"tcp://127.0.0.1:{port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        yield make_scenario_mesh(world_size, device_type)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# the sharded programs
# ----------------------------------------------------------------------------

def _fleet(mesh: ScenarioMesh, iters, viol, status=None):
    """The fleet's aggregates of this rank's lanes: total iterations (SUM),
    max violation (MAX) and, with ``status``, successes (SUM)."""
    out = (mesh.all_reduce(iters.sum(dtype=torch.int64), dist.ReduceOp.SUM),
           mesh.all_reduce(viol.amax().clone(), dist.ReduceOp.MAX))
    if status is None:
        return out
    return out + (mesh.all_reduce(status.sum(dtype=torch.int64),
                                  dist.ReduceOp.SUM),)


def sharded_solve(prob: Problem, opts: SolverOptions, x0s,
                  mesh: ScenarioMesh):
    """Solve a batch of problems differing in x0 (x0s [B, n], the whole
    batch on every rank), each rank its contiguous slice, through the
    port's batched solve (``graph.solve``: CUDA graphs on a card).

    Returns (this rank's U [B / size, N-1, m], the fleet's total iterations,
    the fleet's max violation). B must divide evenly over the ranks. The
    problem is moved to the mesh's device."""
    prob = tree_to(prob, mesh.device)
    sol = graph.solve(dataclasses.replace(prob, x0=mesh.shard(x0s)), opts)
    total_iters, max_viol = _fleet(mesh, sol.stats.iterations,
                                   sol.stats.viol)
    return sol.U, total_iters, max_viol


class ShardedMPCStep:
    """The sharded full MPC step (:func:`sharded_mpc_step`): ``step(state,
    noise)`` with state = (x0s, Xs, Us, duals, k), the first four this
    rank's lanes and the window index ``k`` shared; ``noise`` is this
    rank's rows [B / size, n]. ``results`` holds this rank's
    :class:`~altro_tpu_torch.mpc.MPCResults` of the last step."""

    def __init__(self, prob_mpc: Problem, opts: SolverOptions, X_track,
                 U_track, mesh: ScenarioMesh):
        self.prob_mpc, X_track, U_track = tree_to(
            (prob_mpc, X_track, U_track), mesh.device)
        self.opts, self.mesh = opts, mesh
        self.inner, _ = make_mpc_step(self.prob_mpc, opts, X_track,
                                      U_track, shared_k=True)
        self.results: Optional[MPCResults] = None

    def init_state(self, x0s):
        """The state before the first step: the batched cold solve of this
        rank's slice of x0s [B, n] (the whole batch), window index 0."""
        x0 = self.mesh.shard(x0s)
        sol = graph.solve(dataclasses.replace(self.prob_mpc, x0=x0),
                          self.opts)
        return (x0, sol.X, sol.U, sol.duals, 0)

    def __call__(self, state, noise):
        x0s, Xs, Us, duals, k = state
        carry, out = self.inner((x0s, Xs, Us, duals), noise, k)
        self.results = out
        # after the step's graphs (which returned clones), outside capture
        metrics = _fleet(self.mesh, out.iters, out.viol, out.status)
        return carry + (k + 1,), metrics


def sharded_mpc_step(prob_mpc: Problem, opts: SolverOptions, X_track,
                     U_track, mesh: ScenarioMesh) -> ShardedMPCStep:
    """The sharded full MPC step, the framework's training-step analog: on
    every rank and for each of its scenarios, propagate and perturb x0,
    advance the tracking window, shift the warm starts (states by the exact
    seam corrector) and re-solve, through the port's
    ``make_mpc_step(shared_k=True)`` on the rank's slice; then the fleet's
    metrics (total iterations, max violation, successes), reduced over the
    ranks. Returns a :class:`ShardedMPCStep`: ``step(state, noise) ->
    (state, (total_iters, max_viol, n_success))``."""
    return ShardedMPCStep(prob_mpc, opts, X_track, U_track, mesh)


def run_sharded_mpc(prob_mpc: Problem, opts: SolverOptions, X_track,
                    U_track, x0s, noise, *, mesh: ScenarioMesh) -> dict:
    """The sharded step's closed loop on this rank: the cold batched solve
    of its slice of x0s [B, n], then one step per row of ``noise``
    [T, B, n] (the whole batch). Returns {"results": this rank's
    MPCResults per step, "metrics": the fleet's (total_iters, max_viol,
    n_success) per step, "state": the final state}."""
    step = sharded_mpc_step(prob_mpc, opts, X_track, U_track, mesh)
    state = step.init_state(x0s)
    results, metrics = [], []
    for t in range(len(noise)):
        state, m = step(state, mesh.shard(noise[t]))
        results.append(step.results)
        metrics.append(m)
    return {"results": results, "metrics": metrics, "state": state}


def run_compacted_steps(prob_mpc: Problem, opts: SolverOptions, X_track,
                        U_track, noise, *, mesh: ScenarioMesh, it_cap: int,
                        block: int, levels: tuple = ()) -> list:
    """The device-compacted MPC step on this rank's slice, compaction
    gathering within the slice: the plain step's cold init carry, then one
    step per row of ``noise`` [T, B, n] (the whole batch) in the schedule
    (``it_cap``, ``block``, ``levels``). Returns this rank's MPCResults
    per step."""
    prob_mpc, X_track, U_track = tree_to((prob_mpc, X_track, U_track),
                                         mesh.device)
    step, init_carry = make_mpc_step_device_compacted(
        prob_mpc, opts, X_track, U_track, it_cap=it_cap, block=block,
        levels=levels)
    lo, hi = mesh.bounds(noise.shape[1])
    carry, outs = init_carry(hi - lo), []
    for t in range(len(noise)):
        carry, out = step(carry, mesh.shard(noise[t]), t)
        outs.append(out)
    return outs


# ----------------------------------------------------------------------------
# spawning the ranks
# ----------------------------------------------------------------------------

def _to_host(tree):
    """``tree`` with every tensor a numpy array (results cross the process
    boundary by value, never through shared memory a finished rank no
    longer serves)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to_host(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _to_torch(tree):
    """The inverse of :func:`_to_host`: numpy arrays back to tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to_torch(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return tree


def _rank_main(rank, world_size, device_type, port, calls, out):
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        with process_group(rank, world_size, device_type, port) as mesh:
            results = [fn(*args, mesh=mesh) for fn, *args in calls]
        out.put(("ok", rank, _to_host(results)))
    except BaseException:
        out.put(("error", rank, traceback.format_exc()))
        raise


def launch(calls, world_size: int, device: str = "cuda") -> list:
    """Run ``calls`` on ``world_size`` spawned ranks of a new process group
    on this host and return their results, [rank][call].

    ``calls`` is a sequence of ``(fn, *args)``; each rank calls
    ``fn(*args, mesh=mesh)`` in turn with its :class:`ScenarioMesh`, so
    ``fn`` is a module-level function of the port (the ranks import the
    port and nothing of the caller's module). ``device`` "cuda" gives rank
    r card r (NCCL), "cpu" the CPU (gloo), one thread per rank (a rank's
    lanes then round as they would in one batch). Tensors in the results
    come back as CPU tensors. A rank that raises, dies or outlasts
    LAUNCH_TIMEOUT_S ends every rank and raises here."""
    if device not in BACKENDS:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks need {world_size} cards, "
                           f"this host has {torch.cuda.device_count()}: no "
                           f"rank shares a card")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, device, port, list(calls),
                               out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    try:
        while len(results) < world_size:
            try:
                kind, rank, payload = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank(s) exited without a result: "
                                       f"(rank, exit code) {dead}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks outlasted "
                                       f"{LAUNCH_TIMEOUT_S} s")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{payload}")
            results[rank] = _to_torch(payload)
        for p in procs:
            p.join(timeout=60.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return [results[r] for r in range(world_size)]
