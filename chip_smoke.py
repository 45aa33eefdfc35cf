"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Refuse to run without a CUDA card; turn TF32 off (the reference is fp32);
   print the card's name and power limit.
2. Build every kernel of the port from its source in this checkout and
   print the build seconds.
3. Kernel phase: each kernel at the main path's shapes against its plain
   PyTorch version on the same inputs, with its tolerance; times by CUDA
   events (median after a warm-up) beside the bound for the same work.
4. Main path at full width: ResNet-50 PSPNet + CWT with a seeded random
   init, 8 synthetic 1-shot episodes at 473 px, adapt_iter 200. First, at
   the raw init, the kernel and the plain loop in fp32 (card and host) are
   each held against the plain loop in fp64 on the same features
   (``raw_init_witness``: the loop is chaotic at those feature norms).
   Then the BN statistics are calibrated on other synthetic episodes. The
   launch counts are set to 0 just before ``serve_batch`` +
   ``eval_metrics_batch`` and read just after; every kernel must have
   launched. The same episodes
   and classifier inits then go through the plain inner loop and the masks
   must agree on >= 99.5% of pixels. Episodes/s for serve and eval.
5. The evaluation entry point ``train.test.main`` on configs/pascal.yaml
   with synthetic episodes; its mIoU line is printed.
6. A ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn as nn

# H100 SXM data-sheet peaks (dense): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

E, SHOT, IMG, FEAT, CH, STEPS, CLS_LR = 8, 1, 473, 60, 512, 200, 0.1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def host_seconds(fn, reps: int) -> float:
    """Median host seconds of ``fn()`` ending in a synchronise."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def inner_loop_work(e, shot, h, w, c, big_h, big_w, steps):
    """(flops, bytes) the K1 function needs, each input read once and the
    output written once. Per shot and step: d = f.u and acc += G.f (2hwC
    FLOP each); T = d B^T, D = A T, gB = g B and G = A^T gB counted by the
    non-zeros of the align-corners matrices A (H, h) and B (W, w), two taps
    per row; g = pw sigma(D) - pwy as 5 ops per pixel (exp, add, divide,
    multiply, subtract)."""
    from few_shot_seg_cwt_tpu_torch.ops.resize import interp_matrix_align_corners
    nnz_a = np.count_nonzero(interp_matrix_align_corners(big_h, h))
    nnz_b = np.count_nonzero(interp_matrix_align_corners(big_w, w))
    per_step = (2 * 2 * h * w * c + 2 * h * nnz_b + 2 * nnz_a * big_w
                + 5 * big_h * big_w + 2 * big_h * nnz_b + 2 * nnz_a * w)
    flops = e * shot * steps * per_step
    nbytes = 4 * (e * shot * h * w * c + 2 * e * shot * big_h * big_w + 2 * e * c)
    return flops, nbytes


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, images: torch.Tensor) -> None:
    """Set every BN's running statistics to those of ``images`` (NHWC).

    A random init has unit running variances, so activations grow through
    the 16 residual blocks and the features come out with per-pixel norms in
    the thousands, where the 200-step inner loop at cls_lr 0.1 is chaotic.
    One pass in train mode with cumulative averaging gives the statistics a
    trained network would carry, and features of a trained network's scale.
    The model is left in eval mode.
    """
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average over the calibration pass
    model.train()
    try:
        model.extract_features(images)
    finally:
        for m, mom in zip(bns, momenta):
            m.momentum = mom
        model.eval()


@torch.no_grad()
def raw_init_witness(engine, batch, w0, cuda_inner_loop, binary_pixel_weights):
    """The kernel and two plain fp32 loops (on the card and on the host), each
    against the plain loop in fp64, on the raw random init's features
    (per-pixel norms in the thousands).

    After 1 step the loop is not yet chaotic: all three must be within 1e-5
    relative of fp64. Later, rounding is amplified step by step, so the two
    plain fp32 loops measure how far a correct fp32 order drifts. The kernel's
    acc may drift from fp64 at most 4x as far as the farther plain loop's, at
    every step count; after 200 steps its masks may differ from the fp64
    masks at most 3x as often as the plain loops' do, plus 0.5% of pixels.
    """
    f_s, f_q = engine._episode_features(batch)
    pw, pwy = binary_pixel_weights(batch["s_label"])
    u0 = (w0[:, 1] - w0[:, 0]).contiguous()
    host = [t.cpu() for t in (f_s, pw, pwy, u0)]
    wide = [t.double() for t in (f_s, pw, pwy, u0)]
    norm = float(f_s.norm(dim=-1).median())
    size = tuple(batch["q_label"].shape[-2:])

    def mask(acc):
        acc = acc.to(f_q.device, torch.float32)
        w = torch.stack([w0[:, 0] + CLS_LR * acc, w0[:, 1] - CLS_LR * acc], dim=1)
        return engine.mask_from_prediction(engine._predict(f_q, w)[0], size)

    rows = []
    for steps in (1, 10, 50, STEPS):
        acc_64 = cuda_inner_loop.adapt_binary_reference(*wide, steps, CLS_LR)
        accs = {
            "kernel": cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, steps, CLS_LR),
            "plain_gpu": cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, steps, CLS_LR),
            "plain_cpu": cuda_inner_loop.adapt_binary_reference(*host, steps, CLS_LR),
        }
        m_64 = mask(acc_64)
        rel, diff, per_ep = {}, {}, {}
        for name, acc in accs.items():
            acc = acc.to(acc_64.device, torch.float64)
            rel[name] = float((acc - acc_64).abs().max() / acc_64.abs().max())
            ne = (mask(acc) != m_64).float().mean(dim=(1, 2))
            diff[name], per_ep[name] = float(ne.mean()), [round(float(x), 5) for x in ne]
        rows.append({"steps": steps, "rel_acc_vs_fp64": rel,
                     "mask_diff_vs_fp64": diff, "per_episode_mask_diff": per_ep})
    print(f"raw init (median per-pixel feature norm {norm:.1f}): kernel and plain "
          f"fp32 inner loops vs plain fp64, by steps: {json.dumps(rows)}")
    if max(rows[0]["rel_acc_vs_fp64"].values()) > 1e-5:
        raise AssertionError(f"after 1 step at raw-init norms an fp32 loop is off "
                             f"fp64 by more than 1e-5 relative: {rows[0]}")
    for row in rows[1:]:
        rel = row["rel_acc_vs_fp64"]
        if rel["kernel"] > 4 * max(rel["plain_gpu"], rel["plain_cpu"]):
            raise AssertionError(f"the kernel drifts from fp64 over 4x as far as the "
                                 f"plain fp32 loops: {row}")
    diff = rows[-1]["mask_diff_vs_fp64"]
    allowed = 3 * max(diff["plain_gpu"], diff["plain_cpu"]) + 0.005
    if diff["kernel"] > allowed:
        raise AssertionError(f"after {STEPS} steps the kernel's masks differ from fp64 "
                             f"on {diff['kernel']:.4%} of pixels, more than the "
                             f"allowed {allowed:.4%}")
    return norm


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
    from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
    from few_shot_seg_cwt_tpu_torch.episodic.inner_loop import binary_pixel_weights
    from few_shot_seg_cwt_tpu_torch.ops import cuda_inner_loop
    from few_shot_seg_cwt_tpu_torch.tools.profile_inner_loop import cuda_ms
    from few_shot_seg_cwt_tpu_torch.train import test as test_entry

    # ---- 2. build every kernel ----
    t0 = time.perf_counter()
    cuda_inner_loop.load_library()
    print(f"build: 1 kernel (K1) in {time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda")
    rng = np.random.default_rng(2021)
    episodes = make_episode_batch(7, E, size=IMG, shot=SHOT)

    # ---- 3. kernel phase: K1 at main-path shapes ----
    f_s = torch.tensor(np.abs(rng.standard_normal((E, SHOT, FEAT, FEAT, CH)))
                       .astype(np.float32), device=dev)
    s_label = torch.tensor(episodes["s_label"], device=dev).long()
    pw, pwy = binary_pixel_weights(s_label)
    u0 = torch.tensor((rng.uniform(-2, 2, (E, CH)) / np.sqrt(CH)).astype(np.float32),
                      device=dev)
    acc_k = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, STEPS, CLS_LR)
    acc_p = cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, STEPS, CLS_LR)
    torch.cuda.synchronize()
    k1_err = float((acc_k - acc_p).abs().max())
    k1_scale = float(acc_p.abs().max())
    k1_tol = 1e-4 * k1_scale
    print(f"K1 adapt_binary: max|acc_k - acc_p| = {k1_err:.3e} "
          f"(tolerance 1e-4 * max|acc_p| = {k1_tol:.3e})")
    if not np.isfinite(k1_err) or k1_err > k1_tol:
        raise AssertionError(f"K1 disagrees with its plain version: {k1_err} > {k1_tol}")
    k1_ms = cuda_ms(lambda: cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, STEPS, CLS_LR), 5)
    k1_plain_ms = cuda_ms(
        lambda: cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, STEPS, CLS_LR), 5)
    flops, nbytes = inner_loop_work(E, SHOT, FEAT, FEAT, CH, IMG, IMG, STEPS)
    k1_bound, k1_bound_by = bound(flops, nbytes)
    print(f"K1 adapt_binary: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms, "
          f"bound {k1_bound:.3f} ms ({k1_bound_by}: {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB), library_ms null [{card}]")

    # ---- 4. main path at full width ----
    cfg = load_cfg("configs/pascal.yaml")
    cfg = merge_cfg_from_list(cfg, ["cls_lr", str(CLS_LR), "episode_batch", str(E)])
    if (cfg.image_size, cfg.adapt_iter, cfg.layers) != (IMG, STEPS, 50):
        raise AssertionError("configs/pascal.yaml no longer gives the main path")
    engine = EpisodicEngine(cfg, device="cuda")
    w0 = engine.init_weights(E, torch.Generator().manual_seed(3))
    batch = engine.to_device(episodes)
    raw_norm = raw_init_witness(engine, batch, w0, cuda_inner_loop, binary_pixel_weights)
    # BN statistics from a synthetic calibration batch (other episodes than
    # the ones scored) so features have a trained network's scale, where the
    # 200-step inner loop is well-conditioned
    calib = make_episode_batch(11, E // 2, size=IMG, shot=SHOT)
    calibrate_batchnorm(engine.backbone, torch.tensor(
        np.concatenate([calib["s_img"][:, 0], calib["q_img"]]), device=dev))

    cuda_inner_loop.reset_launches()
    masks = engine.serve_batch(episodes, w0=w0)
    metrics = engine.eval_metrics_batch(episodes, w0=w0)
    torch.cuda.synchronize()
    launches = dict(cuda_inner_loop.LAUNCHES)
    print(f"main path launches: {launches}")
    if launches["adapt_binary"] < 1:
        raise AssertionError("the main path did not launch the K1 kernel")
    if tuple(masks.shape) != (E, IMG, IMG):
        raise AssertionError(f"mask shape {tuple(masks.shape)}")
    if not set(masks.unique().tolist()) <= {0, 1}:
        raise AssertionError(f"mask values {masks.unique().tolist()}")
    for k in ("inter", "union", "inter0", "union0", "loss", "loss0"):
        if not torch.isfinite(metrics[k]).all():
            raise AssertionError(f"non-finite {k}")

    # the same episodes and inits through the plain inner loop, called directly
    with torch.no_grad():
        f_s_ep, f_q = engine._episode_features(batch)
        print(f"median per-pixel feature norm: raw init {raw_norm:.1f}, calibrated "
              f"{float(f_s_ep.norm(dim=-1).median()):.1f}")
        pw_ep, pwy_ep = binary_pixel_weights(batch["s_label"])
        acc = cuda_inner_loop.adapt_binary_reference(
            f_s_ep, pw_ep, pwy_ep, (w0[:, 1] - w0[:, 0]).contiguous(), STEPS, CLS_LR)
        w_plain = torch.stack([w0[:, 0] + CLS_LR * acc, w0[:, 1] - CLS_LR * acc], dim=1)
        pred_q, pred_q0 = engine._predict(f_q, w_plain)
        masks_plain = engine.mask_from_prediction(pred_q, (IMG, IMG))
        metrics_plain = engine.metrics_from_predictions(pred_q, pred_q0, batch)
    agree = float((masks == masks_plain).float().mean())
    fg_k = (metrics["inter"][:, 1] / metrics["union"][:, 1].clamp(min=1)).cpu().numpy()
    fg_p = (metrics_plain["inter"][:, 1] / metrics_plain["union"][:, 1].clamp(min=1)).cpu().numpy()
    print(f"kernel vs plain inner loop: mask agreement {agree:.6f} (>= 0.995 needed); "
          f"per-episode fg IoU kernel {np.round(fg_k, 4).tolist()} "
          f"plain {np.round(fg_p, 4).tolist()}")
    if agree < 0.995:
        raise AssertionError(f"mask agreement {agree} < 0.995")

    serve_s = host_seconds(lambda: engine.serve_batch(episodes, w0=w0), 3)
    eval_s = host_seconds(lambda: engine.eval_metrics_batch(episodes, w0=w0), 3)
    print(f"serve_batch: {E / serve_s:.3f} episodes/s ({serve_s * 1e3:.1f} ms per "
          f"batch of {E}); eval_metrics_batch: {E / eval_s:.3f} episodes/s "
          f"({eval_s * 1e3:.1f} ms per batch) [{card}; fp32, TF32 off, "
          f"1-shot, 473 px, adapt_iter {STEPS}]")

    # where a serve batch's device time goes, stage by stage
    with torch.no_grad():
        feat_ms = cuda_ms(lambda: engine._episode_features(batch), 3)
        loop_ms = cuda_ms(lambda: engine._adapted_episode(batch, w0), 1, warmup=0) - feat_ms
        tail_ms = cuda_ms(lambda: engine.mask_from_prediction(
            engine._predict(f_q, w_plain)[0], (IMG, IMG)), 3)
    print(f"serve batch of {E} by stage: backbone {feat_ms:.1f} ms, inner loop "
          f"(K1) {loop_ms:.1f} ms, CWT + prediction + 473 px tail {tail_ms:.1f} ms "
          f"[{card}]")

    # ---- 5. the evaluation entry point ----
    tcfg = load_cfg("configs/pascal.yaml")
    tcfg = merge_cfg_from_list(tcfg, ["synthetic_data", "True", "test_num", "16",
                                      "n_runs", "1", "episode_batch", str(E)])
    lines = []
    miou = test_entry.main(tcfg, device="cuda", log=lines.append)
    miou_line = next(l for l in lines if l.startswith("mIoU---Val result"))
    print(f"train.test.main: {miou_line} (returned {miou:.4f}; random init, "
          "synthetic episodes)")
    if not np.isfinite(miou):
        raise AssertionError("entry point returned a non-finite mIoU")

    kernels = [{
        "name": "adapt_binary",
        "route": "cuda",
        "source": "few_shot_seg_cwt_tpu_torch/csrc/inner_loop.cu",
        "replaces": "few_shot_seg_cwt_tpu/ops/pallas_inner_loop.py:37",
        "launches": launches["adapt_binary"],
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # run from the checkout's root whatever the caller's directory
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    sys.exit(main())
