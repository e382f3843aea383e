"""Analytic roofline accounting for the hot stages, against the H100.

Port of ``pointslot_tpu/utils/roofline.py``: each hot stage gets an
explicit FLOP and byte model (the reference's arithmetic, unchanged), and
``analyze`` turns a measured time into the FLOP and memory-rate shares,
the speed-of-light time and the binding resource.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, dense
rates from the data sheet. The engines keep the reference's names: "bf16"
is the tensor cores' bf16 rate, "f32" and "vpu" the float32 rate outside
the tensor cores (float32 matmuls run in full float32: TF32 is off).

``frontend_models`` keeps the reference's models, which describe the TPU
kernels: its patch_dma is the TPU gather (a bf16 DMA window and two
one-hot shift matmuls a keypoint) and its orient_brief runs on the bf16
engine. The port's CUDA gather reads only the in-plane pixels of each
float32 window and does no arithmetic, and its orient_brief runs in
float32: ``h100_frontend_models`` scores those two stages as the H100
runs them, and is the one to read the card's shares against.

A stage whose compute AND bandwidth shares are both tiny is latency-bound:
its time is dependency chains and launch overhead, and the fix is
restructuring, not faster math. The `bound` field names the regime.
"""

from __future__ import annotations

import dataclasses

from pointslot_torch.ops.patch import PATCH

PEAK_BF16_FLOPS = 989.4e12   # NVIDIA H100 80GB HBM3, 700 W, data sheet
PEAK_F32_FLOPS = 67e12       # NVIDIA H100 80GB HBM3, 700 W, data sheet
HBM_BYTES_PER_S = 3.35e12    # NVIDIA H100 80GB HBM3, 700 W, data sheet

# a stage using under 5% of both resources is dominated by serial latency
_LATENCY_FRAC = 0.05

# the reference patch kernel's aligned DMA window per keypoint (rows, cols):
# patch_dma's model counts it as the reference does
_DMA_RY, _DMA_RX = 56, 256


@dataclasses.dataclass(frozen=True)
class KernelModel:
    """Analytic cost of one stage call.

    flops are counted as 2*M*N*K for matmul-shaped work and 1 per
    add/sub/abs/min for elementwise work; bytes are device-memory traffic
    with each tensor read once and written once, so the model is a LOWER
    bound on traffic and the shares an UPPER bound on headroom.
    """

    name: str
    flops: float
    bytes: float
    engine: str = "vpu"   # "bf16" (tensor cores), "f32" or "vpu" (float32)


def _peak(engine: str) -> float:
    return {
        "bf16": PEAK_BF16_FLOPS,
        "f32": PEAK_F32_FLOPS,
        "vpu": PEAK_F32_FLOPS,
    }[engine]


def analyze(model: KernelModel, measured_ms: float) -> dict:
    """Measured time -> roofline verdict for one stage."""
    peak = _peak(model.engine)
    sol_ms = max(model.flops / peak, model.bytes / HBM_BYTES_PER_S) * 1e3
    base = {
        "ms": round(measured_ms, 4),
        "gflop": round(model.flops / 1e9, 3),
        "mbytes": round(model.bytes / 1e6, 3),
        "sol_ms": round(sol_ms, 4),
        "engine": model.engine,
    }
    if measured_ms < 1e-3:
        # a prefix delta can vanish into timing noise: no shares off a ~0
        # denominator
        return dict(base, mfu=None, bw_frac=None, bound="unmeasured")
    t = measured_ms * 1e-3
    mfu = model.flops / t / peak
    bw_frac = model.bytes / t / HBM_BYTES_PER_S
    if mfu < _LATENCY_FRAC and bw_frac < _LATENCY_FRAC:
        bound = "latency"
    elif bw_frac >= mfu:
        bound = "bandwidth"
    else:
        bound = "compute"
    return dict(base, mfu=round(mfu, 4), bw_frac=round(bw_frac, 4), bound=bound)


def _pyramid_px(height: int, width: int, n_levels: int, scale: float) -> float:
    """Total pixels across one image's pyramid."""
    return sum(
        int(round(height / scale**i)) * int(round(width / scale**i))
        for i in range(n_levels)
    )


def frontend_models(frontend) -> dict:
    """Stage models of the stereo extraction chain (one L+R pair), keyed as
    stagebench's frontend prefixes:
      - pyr_fast_select: pyramid (7-tap blur + resize), FAST (~110 ops/px),
        3x3 NMS and cell top-k; L0 read, pyramid write, ~3 score-map passes;
      - patch_dma: the patch gather, modelled as the reference's kernel
        (an aligned (56, 256) window per keypoint positioned by two one-hot
        shift matmuls);
      - orient_brief: orientation (a (K, P^2) x (P^2, 2) product), the 7x7
        blur over the patches and 256 compares;
      - stereo_sad: 11 shifts x 11x11 SAD over the fetched windows.
    """
    ext = frontend.extractor
    cfg = frontend.config
    h, w = ext.shapes[0]
    K = ext.capacity
    px = _pyramid_px(h, w, cfg.n_levels, cfg.scale_factor)
    pair = 2.0  # L + R images

    pyr_flops = pair * px * (2 * 7 * 2 + 110 + 9)  # blur + FAST + NMS
    pyr_bytes = pair * px * 4 * 5  # L0 + levels out + ~3 score-map passes

    ry, rx = _DMA_RY, _DMA_RX
    dma_bytes = pair * K * (ry * rx * 2 + PATCH * PATCH * 4)  # bf16 in, f32 out
    dma_flops = pair * K * 2 * PATCH * ry * rx

    p2 = PATCH * PATCH
    orient_flops = pair * K * 2 * p2 * 2  # (K, P^2) x (P^2, 2)
    brief_flops = pair * K * (p2 * 2 * 7 * 2 + 256 * 4)  # blur + compares
    ob_bytes = pair * K * p2 * 4 * 3  # patches read 2x + blurred write

    sad_flops = K * 11 * 11 * 11 * 3  # shifts x window x |l-r| ops
    sad_bytes = K * 11 * 21 * 4 * 2  # refine windows

    return {
        "pyr_fast_select": KernelModel("pyr_fast_select", pyr_flops, pyr_bytes, "vpu"),
        "patch_dma": KernelModel("patch_dma", dma_flops, dma_bytes, "bf16"),
        "orient_brief": KernelModel("orient_brief", orient_flops + brief_flops, ob_bytes,
                                    "bf16"),
        "stereo_sad": KernelModel("stereo_sad", sad_flops, sad_bytes, "vpu"),
    }


def h100_frontend_models(frontend) -> dict:
    """``frontend_models`` with the two stages the port runs otherwise:
      - patch_dma: the CUDA gather (csrc/patch_gather.cu), no arithmetic;
        its lower bound on traffic is the 12 bytes of coordinates and the
        float32 patch written a keypoint (the pixels it reads overlap and
        depend on the keypoints: chip_smoke.py's _patch_bound_ms counts
        them on a run's own keypoints);
      - orient_brief: the reference's FLOPs and bytes on the float32 engine
        (TF32 off).
    """
    models = frontend_models(frontend)
    K = frontend.extractor.capacity
    pair = 2.0
    models["patch_dma"] = KernelModel("patch_dma", 0.0,
                                      pair * K * (12 + PATCH * PATCH * 4), "f32")
    ob = models["orient_brief"]
    models["orient_brief"] = KernelModel(ob.name, ob.flops, ob.bytes, "f32")
    return models


def hamming_model(n_query: int, n_train: int) -> KernelModel:
    """Hamming tables as a (Q, 256) x (256, T) bf16 sign product."""
    flops = 2.0 * n_query * n_train * 256
    bytes_ = (n_query * 256 + n_train * 256) * 2 + n_query * n_train * 4
    return KernelModel("hamming_match", flops, bytes_, "bf16")


def ba_iteration_model(P: int, L: int, K: int) -> KernelModel:
    """One LM iteration of the point-major Schur engine
    (solvers/local_ba.py). Dominant products:
      S_cross (laik,lbjk->abij): 2*L*P^2*6*6*3
      U       (lkp,lkij->lpij):  2*L*K*P*6*3
      W2      (lpij,ljk->lpik):  2*L*P*6*3*3
      residual/Jacobian passes:  ~2*L*K*200 elementwise
    Traffic: U, W2 (L,P,6,3) f32 tensors + edge tensors (L,K,...) r/w.
    """
    flops = (
        2.0 * L * P * P * 6 * 6 * 3
        + 2.0 * L * K * P * 6 * 3
        + 2.0 * L * P * 6 * 3 * 3
        + 2.0 * L * K * 200
    )
    bytes_ = (2 * (L * P * 18) + 3 * (L * K * 30)) * 4
    return KernelModel("ba_lm_iter", flops, bytes_, "f32")


def report(models_and_times: dict) -> dict:
    """{name: (KernelModel, measured_ms)} -> {name: verdict-dict}."""
    return {name: analyze(model, ms) for name, (model, ms) in models_and_times.items()}
