"""Epoch-scan training driver: the captured step as the MAIN loop.

Port of ``veles_tpu/epoch_driver.py``.  The unit-graph loop runs one
fused step a minibatch through the host scheduler; this driver instead
replays a captured step (``compiled.ScanProgram``: one CUDA graph a
train step, one an eval step) over whole epochs — or k-epoch chunks —
with the step operands of a chunk uploaded in one go, while keeping the
workflow's host-side brains as they are:

- **Decision** sees the same per-epoch summed metrics it accumulates in
  the graph loop (validation and test evaluated BEFORE each epoch's
  training, as the loader plans test → validation → train, then the
  training pass's totals), through the same ``reduce_metrics`` /
  ``_on_epoch_end``, so improvement tracking, early stopping and logging
  are the same code.  The metrics are read once a chunk.
- **Snapshotter** fires at chunk boundaries through its normal
  ``run()``/``stop()`` gates (snapshot granularity coarsens to the
  chunk).
- **The completion gate is reproduced exactly.**  In the graph loop a
  completing Decision gate-skips FusedCommit, so the stopping epoch's
  LAST update is computed but discarded.  The captured step writes each
  update into the other of two state buffers, so the state before the
  last step is still there; when completion lands before the chunk's
  last epoch, the driver replays the chunk from a kept copy of its input
  state up to the step before the last.

Keys follow the reference's scan, not its graph loop (a divergence the
reference documents): one ``prng.get("dropout").key()`` a chunk, folded
with the epoch's first global step, then with the step within the epoch,
then with the layer index.  With no stochastic layers the driver's
epoch metrics and final weights equal the graph loop's at any chunk
size.

**Under ``--distributed``** (a ``ShardedTrainer`` on the workflow):
every rank holds the whole dataset on its device and replays the same
captured step on its columns of the global plan (its rows of every
minibatch); the step's collectives are inside the graph (NCCL only: a
gloo collective cannot be captured, so the scan raises there on the
card).  The step operands come from the GLOBAL plan (the live batch
size of the whole minibatch).  Streaming does not combine with it.

**Streaming mode** (``stream_window`` W > 0; out-of-core record and
LMDB datasets, or any loader with ``gather_window``): an epoch's plan is
cut into windows of W minibatches; a worker thread gathers the next
window on the host into pinned memory and copies it, on its own stream
and behind an event, into the other of two static device window
buffers while the card trains the current one (``_WindowStager``; with
``stage_ahead`` N there are N + 1 buffers).  Keys: one key an epoch,
folded with each window's first global step, then with the step within
the window (the reference's windows).  The completion gate as above.
``dispatches`` counts the card's dispatches: each graph replay, train
and eval, so an epoch adds its steps plus its eval minibatches (the
reference counts one program a window and one a set's evaluation).
"""

from __future__ import annotations

import threading
import time

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.loader.base import TRAIN, VALID, TEST

#: minibatches a window when the loader streams and no window is given
DEFAULT_STREAM_WINDOW = 16


class _WindowStager:
    """Stages training windows into ``len(slots)`` static device buffers.

    ``submit(j, gidx, slot)`` hands window j (its global sample indices,
    (rows, mb)) to a worker thread, which gathers it on the host
    (``loader.gather_window``) into slot's pinned buffer and, on the
    card, copies it on its own stream into the slot's device buffers,
    recording an event; the copy waits for the event the driver records
    when the card is done with the slot's previous window.  ``take(j)``
    blocks until window j is staged (the blocked time is the staging
    stall) and makes the current stream wait for its copy."""

    def __init__(self, loader, datas, labels, device, name="stager"):
        import concurrent.futures
        self.loader = loader
        self.datas, self.labels = datas, labels
        self.cuda = device.type == "cuda"
        self.device = device
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=name)
        self._pending = {}
        self._lock = threading.Lock()
        n = len(datas)
        self.released = [None] * n        # the card is done with the slot
        self._copied = [None] * n         # the slot's last copy
        self._pinned = [None] * n
        self._stream = torch.cuda.Stream(device) if self.cuda else None
        self.stall_seconds = 0.0

    def _stage(self, gidx, slot):
        data, labels = self.loader.gather_window(
            numpy.ascontiguousarray(gidx, numpy.int32).ravel())
        n = len(data)
        if not self.cuda:
            self.datas[slot][:n].copy_(torch.from_numpy(data))
            if self.labels[slot] is not None:
                self.labels[slot][:n].copy_(torch.from_numpy(labels))
            return
        if self._copied[slot] is not None:
            # the pinned buffer is free once its last copy is done
            self._copied[slot].synchronize()
        if self._pinned[slot] is None:
            self._pinned[slot] = (
                torch.empty(self.datas[slot].shape, dtype=torch.float32,
                            pin_memory=True),
                None if self.labels[slot] is None else torch.empty(
                    self.labels[slot].shape, dtype=torch.int32,
                    pin_memory=True))
        host_x, host_y = self._pinned[slot]
        host_x[:n].numpy()[...] = data
        if host_y is not None:
            host_y[:n].numpy()[...] = labels
        with torch.cuda.stream(self._stream):
            with self._lock:
                released = self.released[slot]
            if released is not None:
                self._stream.wait_event(released)
            self.datas[slot][:n].copy_(host_x[:n], non_blocking=True)
            if host_y is not None:
                self.labels[slot][:n].copy_(host_y[:n], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._copied[slot] = event
        return event

    def submit(self, key, gidx, slot):
        self._pending[key] = self._pool.submit(self._stage, gidx, slot)

    def take(self, key):
        fut = self._pending.pop(key)
        begin = time.perf_counter()
        event = fut.result()
        self.stall_seconds += time.perf_counter() - begin
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)

    def release(self, slot):
        """Mark the work enqueued so far as the last that reads
        ``slot``."""
        if self.cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            with self._lock:
                self.released[slot] = event

    def shutdown(self):
        for fut in self._pending.values():
            fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=True)


class EpochScanDriver(Logger):
    """Drives a fused StandardWorkflow through captured-step chunks
    (device-resident datasets) or streamed windows (``stream_window`` >
    0, or a loader that can only stream)."""

    def __init__(self, wf, chunk=1, stream_window=0, stage_ahead=1):
        from veles_tpu_torch.ops.decision import DecisionGD, DecisionMSE
        self.wf = wf
        self.chunk = max(int(chunk), 1)
        self.stream_window = int(stream_window or 0)
        self.stage_ahead = max(int(stage_ahead), 1)
        #: the streaming path's windows, dispatches, staging stall and
        #: compute seconds, samples/s (print_stats and the dashboard's
        #: /metrics read it off the workflow)
        self.stream_stats = None
        runner = getattr(wf, "_fused_runner", None)
        if runner is None:
            raise ValueError("--epoch-scan needs a fused workflow "
                             "(drop --no-fused)")
        loader = wf.loader
        full_batch = (getattr(loader, "original_data", None) is not None
                      and not loader.original_data.is_empty)
        if self.stream_window > 0:
            if not loader.can_gather_windows:
                raise ValueError(
                    "--stream-window needs a loader with gather_window "
                    "(RecordsLoader, LMDBLoader, FullBatchLoader); %s "
                    "has no random-access backing store"
                    % type(loader).__name__)
            self.streaming = True
        elif full_batch:
            self.streaming = False
        elif loader.can_gather_windows:
            self.streaming = True
            self.stream_window = DEFAULT_STREAM_WINDOW
        else:
            raise ValueError(
                "--epoch-scan needs a full-batch loader (dataset "
                "resident in device memory) or a window-gatherable "
                "streaming loader (RecordsLoader/LMDBLoader — see "
                "--stream-window); %s is neither" % type(loader).__name__)
        decision = getattr(wf, "decision", None)
        if not isinstance(decision, (DecisionGD, DecisionMSE)):
            raise ValueError(
                "--epoch-scan supports DecisionGD/DecisionMSE workflows; "
                "%r drives training some other way — use the graph loop"
                % type(decision).__name__)
        if not loader.class_lengths[VALID]:
            raise ValueError("--epoch-scan needs a validation set (the "
                             "stopping rule evaluates it per epoch)")
        self.runner = runner
        self.loader = loader
        self.decision = decision
        #: the run's ScanProgram (its capture seconds and graph launches)
        self.program = None

    # ------------------------------------------------------------------ run
    def _feed_decision(self, train, val, test, counts):
        """Hand one epoch's summed metrics (host dicts) to the decision
        through its normal path (reduce_metrics + _on_epoch_end)."""
        dec = self.decision
        n_train, n_valid, n_test = counts
        current = {}
        if test is not None:
            current["test"] = dec.reduce_metrics(dict(test, count=n_test))
        current["validation"] = dec.reduce_metrics(dict(val, count=n_valid))
        current["train"] = dec.reduce_metrics(dict(train, count=n_train))
        dec._current = current
        dec._on_epoch_end()
        dec._reset_epoch()

    def run(self):
        if self.streaming and getattr(self.wf, "_sharded_trainer",
                                      None) is not None:
            raise ValueError(
                "--stream-window does not combine with --distributed "
                "yet: the windowed path is single-process (multi-host "
                "runs keep the device-resident chunk driver)")
        try:
            if self.streaming:
                self._run_streaming()
            else:
                self._run_chunked()
        finally:
            self.runner.scan = self.program

    def _device(self):
        state = [v for e in self.runner.state for v in e.values()]
        return state[0].device

    def _operands(self, mask, step0, key, window=None):
        """The host operands of an epoch's (or a window's) steps: step s
        has global step ``step0 + s`` and the key ``fold_in(key, s)``
        (None without stochastic layers); ``window`` (its steps)
        restarts the fold at each window start."""
        runner = self.runner
        out = []
        for s in range(len(mask)):
            rng = None
            if key is not None:
                rng = prng.fold_in(key[s // window] if window else key,
                                   s % window if window else s)
            out.append(runner.host_operands(int(mask[s].sum()), step0 + s,
                                            rng))
        return out

    def _finish(self, program):
        """The run's end: the final state out of the static buffers into
        the runner (through the trainer) and the units, the final
        snapshot."""
        runner = self.runner
        state = [{k: v.clone() for k, v in e.items()}
                 for e in program.state]
        trainer = getattr(self.wf, "_sharded_trainer", None)
        if trainer is not None:
            trainer.state = state
            trainer.sync_to_runner()
        else:
            runner.state = state
            runner.sync_to_units()
        snap = getattr(self.wf, "snapshotter", None)
        if snap is not None:
            snap.stop()
        self.wf._finished = True

    def _commit(self, program):
        """A chunk or epoch boundary: the state is addressable — the
        runner (or the trainer) takes it, then the snapshot gates fire."""
        trainer = getattr(self.wf, "_sharded_trainer", None)
        if trainer is not None:
            trainer.state = program.state
        else:
            self.runner.state = program.state
        snap = getattr(self.wf, "snapshotter", None)
        if snap is not None:
            self.loader.epoch_ended = True
            snap.run()
        self._notify_reporters()

    def _notify_reporters(self):
        """The driver bypasses the graph, so it pushes the dashboard's
        rows itself at each commit (the graph loop's reporters run off
        the decision)."""
        from veles_tpu_torch.web_status import StatusReporter
        for unit in self.wf:
            if isinstance(unit, StatusReporter):
                unit.report()

    def _eval_sets(self, loader):
        """{cls: (idx, mask)} of the test and validation plans (fixed:
        these sets never reshuffle)."""
        sets = {}
        for cls in (TEST, VALID):
            idx, mask = loader.plan_arrays(cls)
            if idx is not None:
                sets[cls] = (idx, mask)
        return sets

    # ------------------------------------------------- chunked (resident)
    def _run_chunked(self):
        from veles_tpu_torch.compiled import ScanProgram
        wf = self.wf
        runner, loader, dec = self.runner, self.loader, self.decision
        k = self.chunk
        device = self._device()
        data = loader.original_data.devmem
        labels = None if runner._is_mse else loader.original_labels.devmem
        # --distributed: every rank holds the whole (digest-checked)
        # dataset and trains on its columns of the global plan
        trainer = getattr(wf, "_sharded_trainer", None)
        local = (lambda a: a) if trainer is None else trainer.local_columns
        if trainer is not None:
            trainer.place_dataset(data, labels)
        evals = self._eval_sets(loader)
        counts = {cls: int(m.sum()) for cls, (_, m) in evals.items()}
        first_plan_fresh = loader._position == 0
        steps = loader.plan_arrays(TRAIN)[0].shape[0]
        mb = loader.max_minibatch_size // (
            1 if trainer is None else trainer.data_parts)
        program = self.program = ScanProgram(
            runner, device, [data], [labels], k * steps, mb, steps, k,
            {cls: len(idx) for cls, (idx, _) in evals.items()},
            state=None if trainer is None else trainer.state)
        for cls, (idx, mask) in evals.items():
            program.evals[cls].load(numpy.tile(local(idx), (k, 1)),
                                    numpy.tile(local(mask), (k, 1)))
        stream = prng.get("dropout") if runner._has_stochastic else None
        fused = getattr(wf, "fused_step", None)
        while not bool(dec.complete):
            plans = []
            for _ in range(k):
                if first_plan_fresh:
                    first_plan_fresh = False
                else:
                    loader._plan_epoch()
                plans.append(loader.plan_arrays(TRAIN))
            # the plan is consumed: a snapshot restores like the graph
            # loop's end-of-epoch state (the next consumer replans)
            loader._position = len(loader._order)
            idx = numpy.concatenate([p[0] for p in plans])
            mask = numpy.concatenate([p[1] for p in plans])
            n_train = int(plans[0][1].sum())
            step0 = int(loader.epoch_number) * steps
            key = stream.key() if stream is not None else None
            ops = []
            for e in range(k):
                off = step0 + e * steps
                ops += self._operands(
                    mask[e * steps:(e + 1) * steps], off,
                    None if key is None else prng.fold_in(key, off))
            if trainer is not None:
                # the divisibility check and the cross-process plan guard
                trainer._place_plan(idx, mask, key)
            program.train.load(local(idx), local(mask),
                               program.operand_tables(ops))
            program.train.reset()
            for tab in program.evals.values():
                tab.reset()
            if k > 1:
                program.keep()
            for _ in range(k):
                for cls, (eidx, _) in evals.items():
                    for _ in range(len(eidx)):
                        program.replay_eval(cls)
                for _ in range(steps):
                    program.replay_train()
            done_row = None
            for e in range(k):
                loader.epoch_number = int(loader.epoch_number) + 1
                self._feed_decision(
                    program.train.group_totals(e),
                    program.evals[VALID].group_totals(e),
                    (program.evals[TEST].group_totals(e)
                     if TEST in evals else None),
                    (n_train, counts[VALID], counts.get(TEST, 0)))
                if fused is not None:
                    # the graph loop dispatches (and counts) the stopping
                    # epoch's last minibatch even though it is dropped
                    fused.train_steps += steps
                if bool(dec.complete):
                    done_row = e
                    break
            if done_row == k - 1:
                # the state before the chunk's last step
                program.cur = 1 - program.cur
            elif done_row is not None:
                program.restore_kept()
                program.train.t.zero_()
                for _ in range((done_row + 1) * steps - 1):
                    program.replay_train()
            if trainer is not None:
                # the graph loop counts the stopping epoch's last step too
                trainer.step_count = step0 + (
                    k if done_row is None else done_row + 1) * steps
            self._commit(program)
        self._finish(program)

    # ------------------------------------------------ streaming (windowed)
    def _run_streaming(self):
        from veles_tpu_torch.compiled import ScanProgram
        wf = self.wf
        runner, loader, dec = self.runner, self.loader, self.decision
        W = self.stream_window
        device = self._device()
        mb = loader.max_minibatch_size
        evals = self._eval_sets(loader)
        counts = {cls: int(m.sum()) for cls, (_, m) in evals.items()}
        steps = loader.plan_arrays(TRAIN)[0].shape[0]
        W = min(W, steps)
        want_labels = not runner._is_mse

        def probe(n):
            x, y = loader.gather_window(numpy.zeros(1, numpy.int32))
            data = torch.zeros((n,) + x.shape[1:], dtype=torch.float32,
                               device=device)
            lab = (torch.zeros(n, dtype=torch.int32, device=device)
                   if want_labels else None)
            return data, lab

        n_slots = self.stage_ahead + 1
        windows = [probe(W * mb) for _ in range(n_slots)]
        datas = [w[0] for w in windows]
        labels = [w[1] for w in windows]
        # the eval sets: gathered once, resident for the whole run
        eval_at = {}
        for cls, (idx, _) in evals.items():
            x, y = loader.gather_window(idx.ravel().astype(numpy.int32))
            eval_at[cls] = len(datas)
            datas.append(torch.as_tensor(x).to(device))
            labels.append(torch.as_tensor(y).to(device)
                          if want_labels else None)
        program = self.program = ScanProgram(
            runner, device, datas, labels, steps, mb, steps, 1,
            {cls: len(idx) for cls, (idx, _) in evals.items()})
        for cls, (idx, mask) in evals.items():
            local = numpy.arange(idx.size).reshape(idx.shape)
            program.evals[cls].load(local, mask)
        stager = _WindowStager(loader, datas[:n_slots], labels[:n_slots],
                               device, name=loader.name + "_stager")
        stats = self.stream_stats = {
            "window_minibatches": W, "stage_ahead": self.stage_ahead,
            "epochs": 0, "windows": 0, "dispatches": 0, "train_samples": 0,
            "staging_stall_s": 0.0, "compute_s": 0.0,
            "samples_per_sec": 0.0, "staging_stall_fraction": 0.0}
        wf._stream_stats = stats
        stream = prng.get("dropout") if runner._has_stochastic else None
        fused = getattr(wf, "fused_step", None)
        first_plan_fresh = loader._position == 0
        try:
            while not bool(dec.complete):
                if first_plan_fresh:
                    first_plan_fresh = False
                else:
                    loader._plan_epoch()
                idx, mask = loader.plan_arrays(TRAIN)
                loader._position = len(loader._order)   # plan consumed
                n_train = int(mask.sum())
                step0 = int(loader.epoch_number) * steps
                key = stream.key() if stream is not None else None
                starts = list(range(0, steps, W))
                wkeys = (None if key is None else
                         [prng.fold_in(key, step0 + w0) for w0 in starts])
                local = (numpy.arange(steps)[:, None] % W) * mb + \
                    numpy.arange(mb)[None, :]
                program.train.load(local, mask, program.operand_tables(
                    self._operands(mask, step0, wkeys, W)))
                program.train.reset()
                for tab in program.evals.values():
                    tab.reset()
                for j in range(min(self.stage_ahead, len(starts))):
                    w0 = starts[j]
                    stager.submit(j, idx[w0:w0 + W], j % n_slots)
                # test and validation on the pre-epoch state
                for cls, (eidx, _) in evals.items():
                    for _ in range(len(eidx)):
                        program.replay_eval(cls, eval_at[cls])
                    stats["dispatches"] += len(eidx)
                begin = time.perf_counter()
                stalled = stager.stall_seconds
                for j, w0 in enumerate(starts):
                    slot = j % n_slots
                    stager.take(j)
                    nxt = j + self.stage_ahead
                    if nxt < len(starts):
                        n0 = starts[nxt]
                        stager.submit(nxt, idx[n0:n0 + W], nxt % n_slots)
                    for _ in range(min(W, steps - w0)):
                        program.replay_train(slot)
                    stats["dispatches"] += min(W, steps - w0)
                    stager.release(slot)
                    stats["windows"] += 1
                train = program.train.group_totals(0)   # waits for the card
                stats["compute_s"] += (time.perf_counter() - begin
                                       - (stager.stall_seconds - stalled))
                loader.epoch_number = int(loader.epoch_number) + 1
                self._feed_decision(
                    train, program.evals[VALID].group_totals(0),
                    (program.evals[TEST].group_totals(0)
                     if TEST in evals else None),
                    (n_train, counts[VALID], counts.get(TEST, 0)))
                if fused is not None:
                    fused.train_steps += steps
                stats["epochs"] += 1
                stats["train_samples"] += n_train
                if bool(dec.complete):
                    # the graph loop drops the stopping epoch's last
                    # update: the state before it is in the other buffer
                    program.cur = 1 - program.cur
                busy = stats["compute_s"] + stager.stall_seconds
                stats["staging_stall_s"] = stager.stall_seconds
                stats["staging_stall_fraction"] = (
                    stager.stall_seconds / busy if busy > 0 else 0.0)
                stats["samples_per_sec"] = (
                    stats["train_samples"] / busy if busy > 0 else 0.0)
                self._commit(program)
        finally:
            stager.shutdown()
        self._finish(program)
