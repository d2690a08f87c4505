"""The state/epoch/iteration loop (the JAX package's ``train/loop.py``).

state loop -> epoch loop -> iteration loop, with
  * warm-up freeze control per epoch;
  * the A-GEM replay gradient refreshed before every
    ``AGEMConfig.refresh_every``-th new-image micro-step (at 1, every
    one, as the reference does);
  * replay interleaved into the epoch (``mix_data``) or as a tail pass,
    with the Adam-beta1 swap around replay batches (states >= 1); with
    A-GEM on, no replay pass runs (its gradient carries the replay set);
  * the BiC epoch (states >= 1) after the replay, before the scheduler
    step and the save, so the checkpoint carries the trained scalars;
  * scheduler step, checkpoint save, retention cleanup;
  * the optional final correction (with replay and ``enhance_error``,
    A-GEM off): replay passes training only the ``enhance_error`` term,
    at most 20;
  * ``trainer.next_state()`` between states; a state after the first
    trains epochs 1..``new_state_epoch``;
  * ``--profile``: a torch.profiler trace of the second epoch, with the
    program's spans (``utils/profiling.py``).

The metrics of a micro-step are read one micro-step late
(``flush_pending``): reading them at once would make the host wait for
the device on every step. Each epoch appends its timings to
``trainer.epoch_log``: the seconds of the iteration loop (ending in the
last metric read, which waits for the device), the seconds the loop
waited for the loader, the loader's own mean seconds per batch (in its
thread), the BiC epoch's seconds, and the checkpoint save's blocking
seconds.

On the mesh every rank runs this loop over its data index's slices of the
same batches; the metrics are the global batch's, so ``loss_hist`` (and a
resume) is the same whatever the mesh. Rank 0 prints and records; after
every epoch ``parallel.mesh.check_replicas`` raises if any rank's (whole)
parameters parted from rank 0's (on the model axis and under ZeRO-1 too:
the all-gather after every update must leave them bit-identical).
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import numpy as np

from ..parallel.mesh import check_replicas
from ..utils.profiling import span
from ..utils.recorder import Recorder
from .trainer import ILTrainer


def _timed(loader, waits: List[float]):
    """Iterate ``loader``, adding the seconds each ``next`` took to
    ``waits``; each wait is the span ``cldet.train.loader_wait``."""
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        try:
            with span("cldet.train.loader_wait"):
                batch = next(it)
        except StopIteration:
            return
        finally:
            waits.append(time.perf_counter() - t0)
        yield batch


def train_process(trainer: ILTrainer, recorder: Optional[Recorder] = None,
                  log_every: int = 10) -> None:
    cfg = trainer.cfg
    start_state = cfg.il.start_state
    end_state = cfg.il.end_state
    if end_state is None or end_state < start_state:
        end_state = start_state
    start_epoch = cfg.start_epoch or 1
    end_epoch = cfg.end_epoch or cfg.schedule.new_state_epoch
    if recorder is None or not trainer.primary:
        recorder = Recorder(enabled=False)
    log = print if trainer.primary else (lambda *a, **k: None)

    for cur_state in range(start_state, end_state + 1):
        if cur_state != start_state:
            start_epoch = 1
            end_epoch = cfg.schedule.new_state_epoch
        trainer.end_epoch = end_epoch
        log(f"State {cur_state}: epochs {start_epoch}..{end_epoch}, "
              f"{len(trainer.dataset_train)} train images")

        for cur_epoch in range(start_epoch, end_epoch + 1):
            # profile the SECOND epoch of the first trained state (the
            # first pays for cuDNN's plans and the kernels' first launch),
            # or the only epoch; cli.train closes a trace left open by an
            # exception
            profile_epoch = (start_epoch + 1 if end_epoch > start_epoch
                             else start_epoch)
            profiling = (cfg.profile_dir and trainer.primary and cur_state == start_state
                         and cur_epoch == profile_epoch)
            if profiling:
                from ..utils.profiling import start_trace_guarded

                start_trace_guarded(cfg.profile_dir)
                log(f"profiler: tracing epoch {cur_epoch} -> {cfg.profile_dir}")
            trainer.cur_epoch = cur_epoch
            trainer.train_loader.set_epoch(cur_epoch)
            if trainer.replay_loader is not None:
                trainer.replay_loader.set_epoch(cur_epoch)
            trainer.warm_up(cur_epoch)
            not_warm_classifier = trainer._warm_kind != "output"

            epoch_loss: List[float] = []
            t_epoch = time.perf_counter()
            waits: List[float] = []
            micro_steps = 0

            num_training_iter = len(trainer.train_loader)
            replay_exist = (not cfg.il.agem.enabled
                            and trainer.replay_loader is not None)
            do_mix = (cfg.il.replay.mix_data
                      and cur_epoch > cfg.il.replay.mix_data_start)

            # mix_data schedule, keyed by (seed, state, epoch) so a
            # resumed run draws the same interleave
            replay_iter = None
            do_replay_ids: Dict[int, int] = {}
            if replay_exist and do_mix and not_warm_classifier:
                rng = random.Random(f"{cfg.seed}:{cur_state}:{cur_epoch}")
                num_replay_iter = len(trainer.replay_loader)
                if num_replay_iter <= num_training_iter:
                    ids = rng.sample(range(num_training_iter), k=num_replay_iter)
                    do_replay_ids = {i: 1 for i in ids}
                else:
                    do_replay_ids = {i: 1 for i in range(num_training_iter)}
                    rem = num_replay_iter - num_training_iter
                    i = 0
                    while rem:
                        i = (i + 1) % num_training_iter
                        do_replay_ids[i] += 1
                        rem -= 1
                replay_iter = iter(trainer.replay_loader)

            pending = None

            def flush_pending():
                nonlocal pending
                if pending is None:
                    return
                it, t0, dev_metrics, prefix = pending
                metrics = {k: float(v) for k, v in dev_metrics.items()}
                epoch_loss.append(metrics["total_loss"])
                # total_loss is the full batch loss (the step divides the
                # accumulated gradients by every_iter, not the metric)
                trainer.loss_hist.append(metrics["total_loss"])
                recorder.add_iter_loss(
                    cur_state,
                    {f"{prefix}{k}": v for k, v in metrics.items()}
                    if prefix else metrics,
                )
                if it % log_every == 0:
                    keys = " | ".join(
                        f"{k}: {v:.4f}" for k, v in sorted(metrics.items())
                    )
                    log(f"Epoch {cur_epoch:2d} | Iter {it:3d} | {keys} "
                          f"| Running loss: {np.mean(trainer.loss_hist):.5f} "
                          f"| {time.time() - t0:.2f}s")
                pending = None

            agem_counter = 0
            for iter_num, batch in enumerate(_timed(trainer.train_loader, waits)):
                trainer.set_replay_beta(False)
                if cfg.il.agem.enabled and trainer.agem is not None:
                    if agem_counter % max(cfg.il.agem.refresh_every, 1) == 0:
                        trainer.agem.compute_replay_grad(trainer.model)
                    agem_counter += 1
                t0 = time.time()
                dev_metrics = trainer.run_batch(batch, is_replay=False,
                                                sync_metrics=False)
                micro_steps += 1
                flush_pending()
                pending = (iter_num, t0, dev_metrics, "")

                if (replay_exist and not_warm_classifier and do_mix
                        and iter_num in do_replay_ids):
                    flush_pending()
                    trainer.set_replay_beta(True)
                    for _ in range(do_replay_ids[iter_num]):
                        try:
                            rbatch = next(replay_iter)
                        except StopIteration:
                            break
                        t0r = time.time()
                        m = trainer.run_batch(rbatch, is_replay=True,
                                              sync_metrics=False)
                        micro_steps += 1
                        flush_pending()
                        pending = (iter_num, t0r, m, "replay_")

            flush_pending()

            # tail replay pass: when mix_data is off or cur_epoch <
            # mix_data_start; at exactly mix_data_start neither runs
            if (replay_exist and not_warm_classifier
                    and (not cfg.il.replay.mix_data
                         or cur_epoch < cfg.il.replay.mix_data_start)):
                trainer.set_replay_beta(True)
                for it_r, rbatch in enumerate(trainer.replay_loader):
                    t0r = time.time()
                    m = trainer.run_batch(rbatch, is_replay=True,
                                          sync_metrics=False)
                    micro_steps += 1
                    flush_pending()
                    pending = (it_r, t0r, m, "replay_")
                flush_pending()
                trainer.set_replay_beta(False)
            train_s = time.perf_counter() - t_epoch

            bic_s = None
            if trainer.bic is not None and cur_state > 0:
                t_bic = time.perf_counter()
                bic_loss = trainer.bic.train_epoch(trainer.model)
                bic_s = time.perf_counter() - t_bic
                log(f"BiC epoch loss: {bic_loss:.4f}")

            trainer.step_scheduler(cur_epoch)
            save_s = None
            if cur_epoch % max(cfg.save_every, 1) == 0 or cur_epoch == end_epoch:
                trainer.save(cur_epoch, epoch_loss)
                save_s = trainer.save_blocking_s
            if cur_epoch % 5 == 0:
                trainer.ckpt.auto_delete(cur_state, cur_epoch)
            recorder.end_epoch(cur_state, cur_epoch)
            batch_s = trainer.train_loader.batch_seconds
            record = {
                "state": cur_state, "epoch": cur_epoch, "micro_steps": micro_steps,
                "images": micro_steps * trainer.train_loader.batch_size,
                "train_s": train_s, "loader_wait_s": float(sum(waits)),
                "loader_batch_s": float(np.mean(batch_s)) if batch_s else None,
                "bic_s": bic_s, "save_blocking_s": save_s,
            }
            check_replicas(trainer.mesh, trainer.model)
            trainer.epoch_log.append(record)
            log(f"Epoch {cur_epoch} done: mean loss "
                  f"{np.mean(epoch_loss) if epoch_loss else float('nan'):.4f} "
                  f"({time.perf_counter() - t_epoch:.1f}s; {micro_steps} micro-steps in "
                  f"{train_s:.2f}s, {record['images'] / train_s:.2f} images/s, loader wait "
                  f"{record['loader_wait_s']:.2f}s"
                  + (f", save blocking {save_s * 1e3:.1f} ms" if save_s is not None else "")
                  + ")")
            if profiling:
                from ..utils.profiling import stop_trace_guarded

                stop_trace_guarded()
                log(f"profiler: trace written to {cfg.profile_dir}")

        if (not cfg.il.agem.enabled and trainer.replay_loader is not None
                and cfg.il.final_correction and cfg.il.replay.enhance_error):
            log("Start final correction")
            _final_correction(trainer)
            trainer.save(end_epoch)

        if cur_state != end_state:
            trainer.next_state()
            recorder.next_state()

    # drain an in-flight async checkpoint before returning: a daemon
    # writer must not be killed mid-write at interpreter exit
    trainer.ckpt.wait()


def _final_correction(trainer: ILTrainer, max_rounds: int = 20) -> None:
    """Re-run replay passes until the enhance_error term is clean, at most
    ``max_rounds`` times. Each pass trains ONLY the enhance_error term
    with a plain per-batch optimizer step: no focal terms, no
    accumulation, no clip."""
    for _ in range(max_rounds):
        dirty = False
        for batch in trainer.replay_loader:
            m = trainer.run_batch(batch, is_replay=True, correction=True)
            if m.get("enhance_loss", 0.0) > 0:
                dirty = True
        if not dirty:
            return
