"""Config-driven train / validate / evaluate driver.

Port of ``hplflownet_tpu/train/driver.py`` (the reference's main.py:26-290
and evaluation_bnn.py:17-128): the same config surface, checkpoint policy,
logging and metric protocol.  The steps are ``train.step``'s, eager on the
model's device (the CUDA card unless the config says ``platform: cpu``).
The loader's worker threads produce numpy batches; each is copied to the
device here, on the main thread.

Two JAX-only pieces differ: the port's kernels are window-free, so an
evaluation batch is never re-run in exact mode (a lattice capacity
overflow is still counted and logged), and ``profile_dir`` writes a
``torch.profiler`` Chrome trace of steps [2, 7) of the first epoch.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import time

import numpy as np
import torch

from ..data import DATASETS, Augmentation, BatchLoader, ProcessData
from ..device import resolve_device
from ..lattice import build_pyramid
from ..models import MODELS
from ..models.init import reinit_params
from ..pipeline import make_lattice_spec
from ..utils.logging import AverageMeter, Logger
from ..utils.profiling import StepTimer
from .checkpoint import CheckpointIO
from .geometry2d import get_batch_2d_flow
from .metrics import evaluate_2d, evaluate_3d
from .schedule import make_lr_schedule
from .step import _batch_to, make_eval_step, make_train_step, set_learning_rate

__all__ = ["run", "evaluate", "measure_capacities_from_loader",
           "build_everything"]

# the first step pays the kernels' build and first launches; the port has
# no compile after it, so one step of warm-up (the JAX driver skips two)
TIMER_WARMUP = 1
PROFILE_STEPS = (2, 7)


def _num_real(batch):
    return batch.get("num_real", len(batch["path"]))


def measure_capacities_from_loader(spec_rows, loader, num_batches=8,
                                   slack=1.3, align=256, dim=3, device=None):
    """Probe real vertex counts on a few batches to set static capacities.

    Builds each sample's pyramid on ``device`` (the CUDA card by default)
    with generous capacities and reads the per-scale vertex counts.  A
    count past its capacity is clamped (and the coarser scales' follow
    from the clamped set), so a scale that overflows gets twice the
    capacity and the pyramid is built again: small clouds can need more
    than the first guess (a 128-point cloud has over 5 vertices a point at
    the flagship's scale 2.0).
    """
    dev = resolve_device(device)
    worst = [0] * len(spec_rows)
    spec = None
    for bi, batch in enumerate(loader):
        if bi >= num_batches:
            break
        if spec is None:
            n = batch["pc1"].shape[1]
            generous = [4 * n] * min(3, len(spec_rows)) + \
                [2 * n] * max(0, len(spec_rows) - 3)
            spec = make_lattice_spec(spec_rows, capacities=generous, d=dim)
        db = _batch_to(batch, dev)
        for s in range(batch["pc1"].shape[0]):
            while True:
                with torch.inference_mode():
                    scales = build_pyramid(spec, db["pc1"][s], db["pc2"][s],
                                           db["valid1"][s], db["valid2"][s],
                                           adjoint_plans=False)
                over = [int(sp.pc1_overflow) + int(sp.pc2_overflow)
                        for sp in scales]
                if not any(over):
                    break
                generous = [c * 2 if o else c for c, o in zip(generous, over)]
                spec = make_lattice_spec(spec_rows, capacities=generous, d=dim)
            for i, sp in enumerate(scales):
                worst[i] = max(worst[i], int(sp.pc1_num_valid),
                               int(sp.pc2_num_valid))
    return [int(-(-int(w * slack) // align) * align) for w in worst]


def build_everything(args, logger, device=None):
    """Datasets, loaders, lattice spec, and the model with its initial
    parameters, on ``device`` (the CUDA card by default)."""
    dev = resolve_device(device)
    dataset_cls = DATASETS[args.dataset]
    num_points = args.num_points

    ds_kwargs = dict(num_points=num_points, data_root=args.data_root,
                     strict=bool(args.get_or("strict", True)))
    if args.dataset == "KITTI":
        ds_kwargs["remove_ground"] = bool(args.get_or("remove_ground", True))
    if args.dataset == "FlyingThings3DSubset":
        ds_kwargs["full"] = bool(args.get_or("full", False))

    val_transform = ProcessData(args.data_process, num_points,
                                args.allow_less_points)
    val_dataset = dataset_cls(train=False, transform=val_transform,
                              **ds_kwargs)
    logger.log(f"val_dataset: {len(val_dataset)} samples")
    # epoch 1: the JAX driver draws one val batch for its model-init probe
    # (hplflownet_tpu/train/driver.py:124) before anything else iterates
    # the loader, so its evaluation samples each cloud with the next
    # epoch's RNG; starting there gives both drivers the same points
    val_loader = BatchLoader(val_dataset, args.batch_size, shuffle=False,
                             num_threads=args.get_or("workers", 4),
                             drop_last=False, pad_last=True, epoch=1)

    train_loader = None
    if not args.evaluate:
        train_transform = Augmentation(args.aug_together, args.aug_pc2,
                                       args.data_process, num_points,
                                       args.allow_less_points)
        train_dataset = dataset_cls(train=True, transform=train_transform,
                                    **ds_kwargs)
        logger.log(f"train_dataset: {len(train_dataset)} samples")
        train_loader = BatchLoader(train_dataset, args.batch_size,
                                   shuffle=True, seed=args.get_or("seed", 0),
                                   num_threads=args.get_or("workers", 4))

    caps = args.get_or("lattice_capacities", None)
    if caps is None:
        logger.log("measuring lattice capacities on the val set...")
        caps = measure_capacities_from_loader(
            args.scales_filter_map, val_loader, dim=args.dim, device=dev)
        logger.log(f"lattice_capacities: {caps}")
    spec = make_lattice_spec(args.scales_filter_map, capacities=list(caps),
                             d=args.dim)

    model = MODELS[args.arch](
        scales_filter_map=args.scales_filter_map,
        dim=args.dim,
        use_leaky=bool(args.get_or("use_leaky", True)),
        bcn_use_bias=bool(args.get_or("bcn_use_bias", True)),
        bcn_use_norm=bool(args.get_or("bcn_use_norm", True)),
        last_relu=bool(args.get_or("last_relu", False)),
        compute_dtype=str(args.get_or("compute_dtype", "float32")),
        device=dev,
    )

    # the JAX model's own init is xavier at gain 1 with zero biases
    # (glorot_normal kernels); here every scheme, that one included, is a
    # draw of models.init.reinit_params (reference main.py:100-101)
    init_scheme = str(args.get_or("init", "xavier"))
    init_gain = float(args.get_or("gain", 1.0))
    gen = torch.Generator().manual_seed(int(args.get_or("seed", 0)))
    with torch.no_grad():
        model.load_state_dict(reinit_params(gen, model.state_dict(),
                                            scheme=init_scheme, gain=init_gain))
    if (init_scheme, init_gain) != ("xavier", 1.0):
        logger.log(f"=> re-initialized weights: {init_scheme} "
                   f"(gain {init_gain})")
    n_params = sum(p.numel() for p in model.parameters())
    logger.log(f"=> created model '{args.arch}' ({n_params/1e6:.2f}M params)")
    return dict(model=model, spec=spec, train_loader=train_loader,
                val_loader=val_loader)


def evaluate(args, model, spec, params, val_loader, logger,
             dump_visu: bool = False, timer: StepTimer | None = None):
    """Full metric evaluation (reference evaluation_bnn.py:17-128).

    ``params`` maps names to tensors on the model's device (None: the
    model's own).  Each batch's metrics weigh 1 in the means, as in JAX.
    ``timer`` (a :class:`StepTimer`), if given, is stepped once per batch.
    Returns the six metrics and ``overflowed_batches``.
    """
    dev = next(model.parameters()).device
    eval_step = make_eval_step(model, spec)
    meters = {k: AverageMeter() for k in
              ("epe3d", "acc3ds", "acc3dr", "outliers", "epe2d", "acc2d")}
    save_dir = osp.join(args.ckpt_dir, "visu_" + osp.split(args.ckpt_dir)[-1])
    if dump_visu:
        os.makedirs(save_dir, exist_ok=True)
    epe3d_list, path_list = [], []

    n_overflowed = 0
    for i, batch in enumerate(val_loader):
        _, pred, overflow = eval_step.with_overflow(params,
                                                    _batch_to(batch, dev))
        pred = pred.cpu().numpy()
        if timer is not None:
            timer.step(_num_real(batch))
        if int(overflow):
            # the port's kernels are window-free, so this is capacity
            # overflow: the forward dropped lattice vertices
            n_overflowed += 1
            logger.log(f"note: batch {i} overflowed lattice capacities "
                       f"(count {int(overflow)}); raise lattice_capacities")
        pc1 = np.asarray(batch["pc1"])
        pc2 = np.asarray(batch["pc2"])
        sf = np.asarray(batch["sf"])
        valid = np.asarray(batch["valid1"])

        epe3d, acc3ds, acc3dr, outl = evaluate_3d(pred, sf, valid)
        flow_pred, flow_gt = get_batch_2d_flow(
            pc1, pc1 + sf, pc1 + pred, batch["path"],
            calib_root=args.get_or("calib_root", None))
        epe2d, acc2d = evaluate_2d(flow_pred, flow_gt, valid)

        for key, val in zip(("epe3d", "acc3ds", "acc3dr", "outliers",
                             "epe2d", "acc2d"),
                            (epe3d, acc3ds, acc3dr, outl, epe2d, acc2d)):
            meters[key].update(val)

        if i % args.get_or("print_freq", 50) == 0:
            logger.log(
                f"Test: [{i + 1}/{len(val_loader)}]\t"
                f"EPE3D {meters['epe3d'].val:.4f} ({meters['epe3d'].avg:.4f})\t"
                f"ACC3DS {meters['acc3ds'].avg:.4f}\t"
                f"ACC3DR {meters['acc3dr'].avg:.4f}\t"
                f"Outliers3D {meters['outliers'].avg:.4f}\t"
                f"EPE2D {meters['epe2d'].avg:.4f}\t"
                f"ACC2D {meters['acc2d'].avg:.4f}")

        if dump_visu:
            nr = _num_real(batch)
            np.save(osp.join(save_dir, f"pc1_{i}.npy"), pc1[:nr])
            np.save(osp.join(save_dir, f"sf_{i}.npy"), sf[:nr])
            np.save(osp.join(save_dir, f"output_{i}.npy"), pred[:nr])
            np.save(osp.join(save_dir, f"pc2_{i}.npy"), pc2[:nr])
            epe3d_list.append(epe3d)
            path_list.extend(batch["path"][:nr])

    if path_list:
        np.save(osp.join(save_dir, "epe3d_per_frame.npy"),
                np.array(epe3d_list))
        with open(osp.join(save_dir, "sample_path_list.pickle"), "wb") as fd:
            pickle.dump(path_list, fd)

    if n_overflowed:
        logger.log(f"capacity overflow in {n_overflowed} batches")
    res = (f" * EPE3D {meters['epe3d'].avg:.4f}\t"
           f"ACC3DS {meters['acc3ds'].avg:.4f}\t"
           f"ACC3DR {meters['acc3dr'].avg:.4f}\t"
           f"Outliers3D {meters['outliers'].avg:.4f}\t"
           f"EPE2D {meters['epe2d'].avg:.4f}\t"
           f"ACC2D {meters['acc2d'].avg:.4f}")
    logger.log(res)
    return dict({k: m.avg for k, m in meters.items()},
                overflowed_batches=n_overflowed)


def _check_ckpt_dir(args):
    """An existing ckpt_dir is overwritten only on a confirmed prompt, with
    force_overwrite, or when resuming (reference main.py:36-41)."""
    if osp.exists(args.ckpt_dir) and not args.evaluate \
            and not args.get_or("resume", False) \
            and not args.get_or("force_overwrite", False):
        import sys
        from ..utils.logging import confirm
        if sys.stdin.isatty():
            if not confirm(f"Attention: ckpt_dir {args.ckpt_dir} already "
                           "exists. Continue and overwrite?", default=None):
                sys.exit(1)
        else:
            raise RuntimeError(
                f"ckpt_dir {args.ckpt_dir} already exists; set "
                "force_overwrite: true (or resume: true) to proceed")


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def run(args):
    """Entry: train or evaluate per the config (reference main.py:26-200).

    Returns, when training: ``min_val_epe3d``; the last epoch's
    ``train_epe3d`` and ``train_pairs_per_s`` (its :class:`StepTimer`
    rate); ``overflowed_steps`` over all epochs; ``seconds_to_first_step``
    (from the call to the end of the first train step); and the final
    ``state``.  When evaluating: the six metrics, ``pairs_per_s``,
    ``overflowed_batches`` and ``seconds_to_first_step``.
    """
    t_run = time.perf_counter()
    dev = resolve_device(args.get_or("device", None))
    # float32 parity needs full float32 products, whatever
    # matmul_precision says
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _check_ckpt_dir(args)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    logger = Logger(osp.join(args.ckpt_dir, "log"))
    for k in sorted(args):
        logger.log(f"{k:24s} {args[k]}")
    logger.log("")
    logger.log(f"torch device: {_device_name(dev)}")

    built = build_everything(args, logger, device=dev)
    model, spec = built["model"], built["spec"]
    ckpt = CheckpointIO(args.ckpt_dir)

    if args.evaluate:
        if isinstance(args.resume, str) and args.resume not in ("True",):
            io = CheckpointIO(args.resume) if osp.isdir(args.resume) else ckpt
        else:
            io = ckpt
        init_state, _ = make_train_step(model, spec, args.get_or("lr", 1e-4),
                                        device=dev)
        state, epoch, _ = io.restore(init_state())
        logger.log(f"=> loaded checkpoint (epoch {epoch})")
        timer = StepTimer(warmup=TIMER_WARMUP, device=dev)
        metrics = evaluate(args, model, spec, state.params,
                           built["val_loader"], logger,
                           dump_visu=bool(args.get_or("dump_visu", False)),
                           timer=timer)
        logger.close()
        return dict(metrics, pairs_per_s=timer.rate,
                    seconds_to_first_step=timer.first - t_run)

    # ---------------- training ----------------
    lr_fn = make_lr_schedule(args)
    overflow_mode = str(args.get_or("overflow_mode", "skip"))
    init_state, train_step = make_train_step(model, spec, args.lr,
                                             on_overflow=overflow_mode,
                                             device=dev)
    eval_step = make_eval_step(model, spec)
    state = init_state()
    start_epoch = 0
    min_val = None

    if args.get_or("resume", False) and ckpt.exists():
        state, start_epoch, min_val = ckpt.restore(state)
        logger.log(f"=> resumed from epoch {start_epoch}")
        if not np.isfinite(min_val):
            min_val = None
        if args.get_or("reset_lr", False):
            # reference main.py:144-146 rebases lr to args.lr at resume; the
            # per-epoch adjust_learning_rate (main.py:156) reasserts the
            # schedule at the top of the very next epoch, so the rebase is
            # transient; reset_lr_pin keeps args.lr for all remaining epochs
            # (as the JAX driver does)
            logger.log("reset lr")
            state = set_learning_rate(state, args.lr)
            if args.get_or("reset_lr_pin", False):
                lr_fn = lambda _epoch: args.lr  # noqa: E731

    first_step_at = None
    timer = None
    overflowed_steps = 0
    for epoch in range(start_epoch, args.epochs):
        lr = lr_fn(epoch)
        state = set_learning_rate(state, lr)
        logger.log(f"lr: {lr}")

        # train epoch
        meter = AverageMeter()
        timer = StepTimer(warmup=TIMER_WARMUP, device=dev)
        # config `profile_dir`: a torch.profiler trace of steps [2, 7) of
        # the first epoch (Chrome trace format)
        profile_dir = args.get_or("profile_dir", None)
        prof = None
        for i, batch in enumerate(built["train_loader"]):
            if profile_dir and epoch == start_epoch:
                if i == PROFILE_STEPS[0]:
                    prof = _start_profile(dev)
                elif i == PROFILE_STEPS[1]:
                    prof = _stop_profile(prof, profile_dir, logger)
            state, loss, overflow = train_step.with_overflow(
                state, _batch_to(batch, dev))
            meter.update(float(loss), _num_real(batch))
            timer.step(_num_real(batch))
            if first_step_at is None:
                first_step_at = timer.first
            if int(overflow):
                overflowed_steps += 1
                # capacity overflow: the forward dropped lattice vertices,
                # so the gradient is inexact; overflow_mode=skip discarded
                # the update (reference-style continue, main.py:229-244)
                action = ("update skipped" if overflow_mode == "skip"
                          else "gradients inexact")
                logger.log(f"WARNING: lattice overflow count {int(overflow)} "
                           f"at step {i} ({action}; raise "
                           "lattice_capacities)")
            if i % args.get_or("print_freq", 50) == 0:
                rate = timer.rate
                logger.log(f"Epoch: [{epoch + 1}][{i + 1}/"
                           f"{len(built['train_loader'])}]\t"
                           f"EPE3D Loss {meter.val:.4f} ({meter.avg:.4f})\t"
                           f"{rate:.2f} pairs/s")
        _stop_profile(prof, profile_dir, logger)
        logger.log(f" * Train EPE3D {meter.avg:.4f}")

        # validate
        vmeter = AverageMeter()
        for batch in built["val_loader"]:
            loss, _ = eval_step(state.params, _batch_to(batch, dev))
            vmeter.update(float(loss), _num_real(batch))
        logger.log(f" * Val EPE3D {vmeter.avg:.4f}")

        is_best = min_val is None or vmeter.avg < min_val
        if is_best:
            min_val = vmeter.avg
            logger.log("New min val loss!")
        ckpt.save(state, epoch + 1, min_val, is_best=is_best)

    logger.close()
    return {"min_val_epe3d": min_val,
            "train_epe3d": meter.avg if timer is not None else None,
            "train_pairs_per_s": timer.rate if timer is not None else 0.0,
            "overflowed_steps": overflowed_steps,
            "seconds_to_first_step": (None if first_step_at is None
                                      else first_step_at - t_run),
            "state": state}


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir, logger):
    """Stop a running trace and write it; -> None (no trace running)."""
    if prof is not None:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = osp.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        logger.log(f"profile trace written to {path}")
    return None
