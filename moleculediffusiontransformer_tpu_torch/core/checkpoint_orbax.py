"""The production checkpoint tier: async saves and sharded restores, on
``torch.distributed.checkpoint`` (DCP) (port of `core/checkpoint_orbax.py`).

The single-file tier (``core/checkpoint.py``) is the exact-resume baseline:
one ``torch.save`` file a step, written by rank 0 after every shard of an
FSDP model has been gathered.  This tier writes the same state, in another
layout and another way:

  * **async save** -- ``save`` copies the state to host memory (on the card,
    into pinned buffers, enqueued on the current stream, so that the next
    step's in-place updates run after the copy and the host does not wait
    for it) and returns; a background thread writes it, and the train loop
    dispatches its next step meanwhile;
  * **sharded** -- parameters and Adam moments stay in their placement:
    plain tensors in one process or under data parallelism, ``DTensor``
    shards under FSDP2, where each rank writes only its own shards and a
    restore reads only the shards of the target it is given, straight into
    its storage, with no gather;
  * **commit and retention** -- a save is written into ``<step>.tmp`` and
    renamed to ``<step>`` by one rank once every rank's write has ended;
    only committed steps are seen, and the oldest beyond ``keep`` are
    deleted after each commit.

The checkpointer takes its own gloo group (made on every rank when it is
built), so that DCP's collectives, which run in the writer thread, never
share a communicator with the training step's.  A background save's
exception is raised at the next ``save``, ``wait_until_finished`` or
``close``.  The API is the JAX package's, so that a trainer swaps tiers by
``TrainConfig.checkpoint_backend``.
"""
from __future__ import annotations

import os
import re
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

FORMAT = "moleculediffusiontransformer_tpu_torch.checkpoint_orbax/1"
_STEP_RE = re.compile(r"^\d+$")


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _map_tensors(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _stage(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` (a ``DTensor`` keeps its placement, its local
    shard copied): from the card into pinned memory, without waiting."""
    t = t.detach()
    return t.to("cpu", non_blocking=True) if t.is_cuda else t.clone()


class OrbaxCheckpointer:
    """Step checkpoints under ``directory``, one directory a committed step.
    ``save(step, state)`` is async by default; ``restore(target)`` loads
    into ``target``'s own tensors, whatever their placement and device.

    ``state`` and ``target`` are dicts of tensors, nested dicts and Python
    values, alike on every rank; ``shard_restore_target`` makes the one a
    trainer saves and restores.  Every rank of the process group, if one
    is set up, builds the checkpointer and calls each method alike."""

    def __init__(self, directory: str, *, keep: Optional[int] = 3,
                 async_save: bool = True, save_interval_steps: int = 1):
        import torch.distributed as dist
        # the single-file tier takes relative directories too
        self.directory = os.path.abspath(directory)
        if keep is not None and keep < 1:
            raise ValueError(f"keep={keep}: keep at least the newest step")
        self.keep = keep
        self.save_interval_steps = save_interval_steps
        self._group = (dist.new_group(backend="gloo")
                       if dist.is_available() and dist.is_initialized()
                       else None)
        self._rank = 0 if self._group is None else dist.get_rank(self._group)
        self._executor = (ThreadPoolExecutor(1, "checkpoint_orbax")
                          if async_save else None)
        self._pending: Optional[Future] = None
        self._last = self.latest_step()
        # one record a committed save: step, hold_ms (the step stream held
        # by the staging copy: CUDA events on the card, the host's clock on
        # the CPU), commit_seconds (from ``save`` to the commit), bytes
        # (of every rank, and of this rank's files)
        self.saves: List[Dict[str, Any]] = []

    # ----------------------------------------------------------- paths --
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """The committed steps, in order."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if _STEP_RE.match(n)
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------ save --
    def save(self, step: int, state: Dict, *, force: bool = False) -> bool:
        """Stage ``state`` at ``step`` and write it (in the background when
        async).  Returns whether a save was started: a step off
        ``save_interval_steps``, or not past the last saved one, is skipped
        unless ``force``.  Waits for the save before it first."""
        self.wait_until_finished()
        if not force and (step % self.save_interval_steps
                          or (self._last is not None and step <= self._last)):
            return False
        t0 = time.perf_counter()
        on_card = any(t.is_cuda for t in _tensors(state))
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        staged = _map_tensors(_stage, state)
        if on_card:
            end.record()
            timing: Any = (start, end)
        else:
            timing = (time.perf_counter() - t0) * 1e3
        self._last = step
        if self._executor is None:
            self.saves.append(self._write(step, staged, timing, t0))
        else:
            self._pending = self._executor.submit(
                self._write, step, staged, timing, t0)
        return True

    def _barrier(self) -> None:
        if self._group is not None:
            torch.distributed.barrier(group=self._group)

    def _write(self, step: int, staged: Dict, timing: Any,
               t0: float) -> Dict[str, Any]:
        import torch.distributed.checkpoint as dcp
        if isinstance(timing, tuple):          # the staging copy's events
            timing[1].synchronize()
            hold_ms = timing[0].elapsed_time(timing[1])
        else:
            hold_ms = timing
        tmp, final = self._path(step) + ".tmp", self._path(step)
        if self._rank == 0:
            os.makedirs(self.directory, exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)   # an interrupted save's
        self._barrier()
        dcp.save(staged, storage_writer=dcp.FileSystemWriter(tmp),
                 process_group=self._group, no_dist=self._group is None)
        if self._rank == 0:
            if os.path.exists(final):                # a forced save again
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._prune()
        self._barrier()
        meta = dcp.FileSystemReader(final).read_metadata()
        ranks: Dict[int, int] = {}
        for info in meta.storage_data.values():
            rank = int(info.relative_path.split("_")[2])
            ranks[rank] = ranks.get(rank, 0) + info.length
        return {"step": step, "hold_ms": hold_ms,
                "commit_seconds": time.perf_counter() - t0,
                "bytes": sum(ranks.values()),
                "rank_bytes": ranks.get(self._rank, 0)}

    def _prune(self) -> None:
        if self.keep is None:
            return
        steps = self.all_steps()
        for old in steps[:max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self._path(old))

    def wait_until_finished(self) -> None:
        """Block until the save in flight has committed; raise its
        exception if it failed."""
        pending, self._pending = self._pending, None
        if pending is not None:
            self.saves.append(pending.result())

    # --------------------------------------------------------- restore --
    def restore(self, target: Dict, step: Optional[int] = None) -> Dict:
        """Load ``step`` (the latest committed by default) into ``target``
        in place: each tensor's values copied into its own storage (of a
        ``DTensor``, into its local shard: only the shards it holds are
        read), every other value replaced.  Returns ``target``."""
        import torch.distributed.checkpoint as dcp
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None or not os.path.isdir(self._path(step)):
            raise FileNotFoundError(
                f"no committed checkpoint {'' if step is None else step} "
                f"in {self.directory}")
        dcp.load(target, storage_reader=dcp.FileSystemReader(
            self._path(step)), process_group=self._group,
            no_dist=self._group is None)
        if target.get("format", FORMAT) != FORMAT:
            raise ValueError(f"{self._path(step)} is not a checkpoint of "
                             f"this tier: {target['format']!r}")
        return target

    def close(self) -> None:
        """Wait for the save in flight (raising its exception), then stop
        the writer thread."""
        try:
            self.wait_until_finished()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def __enter__(self) -> "OrbaxCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def shard_restore_target(model: torch.nn.Module, state: Any = None,
                         mesh=None) -> Dict:
    """The state a checkpoint of this tier holds, in its current placement:
    what ``OrbaxCheckpointer.save`` writes and what ``restore`` loads into
    (the model's ``state_dict()`` and, when a ``train.trainer.TrainState``
    is given, Adam's moments keyed by parameter name, their count, the step
    and the epochs completed: ``core/checkpoint.py::checkpoint_state``'s
    layout, without its gather).  Under FSDP2 the parameters and moments
    are the ranks' ``DTensor`` shards, so FSDP's placement decides where
    each shard lands; ``mesh``, when given, must be the mesh they are
    sharded over.  The model's tensors share its parameters' storage: a
    restore into them loads the model."""
    from torch.distributed.tensor import DTensor
    out: Dict[str, Any] = {"format": FORMAT, "model": model.state_dict()}
    if state is not None:
        names = [n for n, _ in model.named_parameters()]
        adam = state.opt_state
        out["adam"] = {"mu": dict(zip(names, adam.mu)),
                       "nu": dict(zip(names, adam.nu)),
                       "count": int(adam.count)}
        out["step"] = int(state.step)
        out["epoch"] = int(state.epoch)
    if mesh is not None:
        other = [t for t in _tensors(out)
                 if isinstance(t, DTensor) and t.device_mesh != mesh]
        if other:
            raise ValueError(f"{len(other)} tensors are sharded over "
                             f"another mesh than {mesh}")
    return out


def restore_train_state(checkpointer: OrbaxCheckpointer,
                        model: torch.nn.Module, state: Any,
                        step: Optional[int] = None) -> Tuple[int, Dict]:
    """Restore ``model`` and ``state`` (a ``TrainState``) in place from
    ``step`` (the latest by default): tensors into their placement, then
    Adam's count, the step and the epochs.  Returns (the step, the
    target)."""
    target = checkpointer.restore(shard_restore_target(model, state), step)
    state.opt_state.count = int(target["adam"]["count"])
    state.step = int(target["step"])
    state.epoch = int(target["epoch"])
    return state.step, target
