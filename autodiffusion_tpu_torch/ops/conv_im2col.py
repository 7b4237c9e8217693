"""3x3 convolutions as implicit GEMMs: two hand-written Hopper kernels and
their plain twins.

Port of autodiffusion_tpu/ops/conv_im2col.py. The TPU package wrote the
im2col conv (``_conv_kernel``) and the norm-act-conv that takes the
ResBlock's GroupNorm, FiLM, SiLU and residual into the conv's own pass
(``_fused_conv_kernel``) in Pallas; here they are CUDA C++ kernels in
``ops/csrc/`` (built by ``ops/_build.py`` with nvcc for sm_90a):

  conv3x3         y = conv3x3(x) + bias
  conv3x3_fused   y = conv3x3(silu(x a + b) cast to x's dtype) + bias
                      (+ residual)

Layout: NCHW activations and OIHW weights, the port's own (the TPU kernels
take NHWC and HWIO). The kernels read and write NCHW directly
(csrc/conv3x3.cuh), so no copy of an activation surrounds a call; the
weights go to the kernels in one small copy a call, as [C_out, 3, 3, C_in]
or, for the bf16 implicit GEMM, in tiles of 128 output by 16 input
channels (:func:`_weights`).
Stride 1, SAME padding, float32 or bfloat16, one dtype for x, w and the
output; bias, a, b float32. Each wrapper launches
its kernel on CUDA tensors (and counts the launch) or raises; on CPU
tensors it computes its plain twin.

Numerics: products of x.dtype operands summed in float32, the bias (and in
the fused kernel the residual) added to the float32 sum, one cast. The
plain twins compute the conv in float32 from the same operands. The fused
twin :func:`fused_conv_reference` mirrors the JAX oracle ``_xla_fused_ref``
(conv_im2col.py:460-473): the residual is added after the cast of the conv
output, so in bfloat16 kernel and twin may differ by one rounding there.

Launch plan: :func:`conv_plan` picks, from the shape alone, the kernel a
CUDA call runs and, for the bf16 implicit GEMM, its wgmma width, tile,
ring stages and K splits (csrc/conv3x3.cuh); the wrappers pass it to the
C entry points, and the CPU tests check it at every site of both searches.

Gradients: both differentiate with PyTorch's conv gradients
(``torch.nn.grad``) in the dtype of x and w, as the JAX package's VJPs
differentiate the XLA expressions outside Pallas
(conv_im2col.py:493-512,601-608): the fused backward recomputes
silu(x a + b), takes the conv's input gradient in x's dtype and the SiLU
and affine in float32, and computes a weight, bias or residual gradient
only where autograd asks for one (guidance through a frozen classifier
asks for none).

Gates: :func:`resolve_use_im2col` and :func:`resolve_use_fused_conv` decide
from the channels, the dtype and the environment alone, each one switch
that turns on every eligible site. What the JAX gates took from TPU
measurements or from VMEM and Mosaic legality (measured whitelists, block
pickers, the TPU-backend test) is not carried over: a per-site whitelist
comes back only when an H100 A/B finds a site where a kernel wins.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import launch

__all__ = ["conv3x3", "conv3x3_im2col", "conv3x3_reference", "conv3x3_fused",
           "conv3x3_fused_kernel", "fused_conv_reference", "Conv3x3Function",
           "Conv3x3FusedFunction", "resolve_use_im2col",
           "resolve_use_fused_conv", "ConvPlan", "conv_plan", "igemm_smem"]

def _eligible(c_in: int, c_out: int, dtype) -> bool:
    # tiny contractions (the RGB stem, K = 27) or outputs (the final
    # projection, C_out = 6) leave the tensor cores idle, as in the JAX
    # gate; C_in % 8 keeps the kernels' 16-byte weight loads aligned
    return (c_in >= 64 and c_out >= 64 and c_in % 8 == 0
            and dtype in (torch.float32, torch.bfloat16))


def resolve_use_im2col(c_in: int, c_out: int,
                       dtype=torch.bfloat16) -> bool:
    """Gate of the im2col conv at one Conv3x3 site: every eligible site
    where ``ADT_IM2COL_CONV=1``, none where it is unset or anything else."""
    return (os.environ.get("ADT_IM2COL_CONV") == "1"
            and _eligible(c_in, c_out, dtype))


def resolve_use_fused_conv(c_in: int, c_out: int,
                           dtype=torch.bfloat16) -> bool:
    """Gate of the fused norm-act-conv at one ResBlock norm-conv pair:
    every eligible site where ``ADT_FUSED_CONV=all``, none where it is
    unset or anything else."""
    return (os.environ.get("ADT_FUSED_CONV") == "all"
            and _eligible(c_in, c_out, dtype))


# ---------------------------------------------------------------- plain twins

def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of the conv kernel: the conv of x.dtype operands in
    float32, plus the bias in float32, cast once to x.dtype."""
    b = None if bias is None else bias.float()
    return F.conv2d(x.float(), w.float(), b, padding=1).to(x.dtype)


def fused_conv_reference(x, a, b, w, bias=None, residual=None):
    """Plain twin of the fused conv, the JAX oracle's order
    (conv_im2col.py:460-473): silu(x a + b) in float32 cast to x.dtype,
    the conv (float32 sum, bias, one cast), then the residual added in
    x.dtype. Differentiable through autograd."""
    xf = x.float() * a[:, :, None, None] + b[:, :, None, None]
    out = conv3x3_reference((xf * torch.sigmoid(xf)).to(x.dtype), w, bias)
    return out if residual is None else out + residual


# --------------------------------------------------------------- launch plan

SMS = 132                  # streaming multiprocessors of an H100 SXM
SMEM_BLOCK_MAX = 232448    # 227 KB: the most shared memory one block takes
# the pixel widths the kernel instantiates; a width of 144 (8 rows of 16)
# spilled its 144 accumulators a thread and serialised the wgmmas, and ran
# slower on an H100 than 80 (4 rows of 16) at the 16 x 16 sites (PERF.md)
WGMMA_WIDTHS = (80, 136)
CHUNK = 16                 # input channels per pipeline stage
BM = 128                   # output channels a block (two consumer warpgroups)
SUBTILES = 2               # pixel sub-tiles a block (one wgmma each per tap)


@dataclass(frozen=True)
class ConvPlan:
    """What one CUDA call runs. ``kernel`` is "igemm" (the bf16 implicit
    GEMM), "gather" (bf16 shapes it does not take) or "float32". For the
    implicit GEMM: wgmma width ``nt`` (slab pixels a sub-tile), 128 output
    channels and two sub-tiles of ``rows`` x ``tw`` output pixels a block
    (``packed``: two whole images, else one band of rows above the
    other), ``stages`` ring stages, ``splits`` K splits of
    ``chunks_per_split`` 16-channel chunks, ``smem`` bytes of shared
    memory a block and ``blocks`` blocks of the main pass."""
    kernel: str
    nt: int = 0
    tw: int = 0
    rows: int = 0
    packed: int = 0
    stages: int = 0
    splits: int = 1
    chunks_per_split: int = 0
    smem: int = 0
    blocks: int = 0

    def args(self) -> tuple:
        """The plan's arguments of the C entry points."""
        return (self.nt, self.tw, self.rows, self.packed,
                self.stages, self.splits, self.chunks_per_split)

    def text(self) -> str:
        if self.kernel != "igemm":
            return self.kernel
        return (f"igemm 128x2x{self.rows}x{self.tw}"
                f"{' packed' if self.packed else ''} n{self.nt} "
                f"s{self.stages} k/{self.splits}")


def igemm_smem(nt: int, tw: int, rows: int, packed: int, stages: int,
               w: int) -> int:
    """Shared memory of an implicit-GEMM block (csrc/conv3x3.cuh's
    Geometry): per stage the weights [2][9][128][8], the raw input boxes
    [16][rows of the slab][w if the tile is whole rows, else tw + 16] and
    a, b [2][2][16] float32, and an mbarrier; two slab buffers
    [2][npix][8]."""
    sw = tw + 2
    raw_rows = SUBTILES * (rows + 2) if packed else SUBTILES * rows + 2
    sub_rows = rows + 2 if packed else rows
    need = (SUBTILES - 1) * sub_rows * sw + 2 * sw + 2 + nt
    npix = -(-max(raw_rows * sw, need) // 8) * 8
    raw_w = tw if tw == w else tw + 16
    stage = BM * 9 * CHUNK * 2 + CHUNK * raw_rows * raw_w * 2 \
        + SUBTILES * 2 * CHUNK * 4
    return stages * (stage + 8) + 2 * (2 * npix * 8 * 2)


@functools.lru_cache(maxsize=None)
def conv_plan(batch: int, c_in: int, c_out: int, h: int, w: int,
              dtype=torch.bfloat16) -> ConvPlan:
    """The launch plan of a CUDA call, from the shape alone.

    bf16 with C_in % 16 == 0 and W % 8 == 0 runs the implicit GEMM:
    sub-tiles of whole image rows where W <= 64, else of 64 columns; the
    wgmma width that wastes the fewest pixels on halo columns and ragged
    rows; two sub-tiles a block, two whole images where one fits a
    sub-tile; 128 output channels a block (the last tile masked where
    C_out % 128 != 0); as many ring stages (2-4) as fit one block a SM; and
    K split into runs of whole chunks where that shortens the grid's
    waves over the 132 SMs (with the pipeline's fill and drain and the
    second pass counted), each split at least two chunks and the split
    grid at least 132 blocks."""
    if dtype != torch.bfloat16:
        return ConvPlan("float32")
    if c_in % CHUNK or w % 8:
        return ConvPlan("gather")
    tw = min(w, 64)

    def use(nt):        # output pixels a block computes / slab pixels
        rows = min(nt // (tw + 2), h)
        if not rows:
            return 0.0
        if rows == h and tw == w:       # whole images, one a sub-tile
            return h * w / nt
        band = SUBTILES * rows
        return h * tw / (-(-h // band) * SUBTILES * nt)

    nt = max(WGMMA_WIDTHS, key=lambda n: (use(n), n))
    rows = min(nt // (tw + 2), h)
    packed = int(rows == h and tw == w)
    stages = max(s for s in (2, 3, 4)
                 if igemm_smem(nt, tw, rows, packed, s, w) <= SMEM_BLOCK_MAX)
    if packed:
        tiles = -(-batch // SUBTILES)
    else:
        tiles = batch * -(-h // (SUBTILES * rows)) * -(-w // tw)
    tiles *= -(-c_out // BM)
    chunks = c_in // CHUNK

    def cost(s):
        # in chunk times: waves x (chunks a block + the pipeline's fill
        # and drain), and the second pass where K is split
        per = -(-chunks // s)
        return -(-tiles * s // SMS) * (per + 3) + (2 if s > 1 else 0)

    splits = 1
    for s in range(2, 9):
        per = -(-chunks // s)
        if per < 2 or -(-chunks // per) != s or tiles * s < SMS:
            continue
        if cost(s) < cost(splits):
            splits = s
    per = -(-chunks // splits)
    return ConvPlan("igemm", nt, tw, rows, packed, stages, splits, per,
                    igemm_smem(nt, tw, rows, packed, stages, w),
                    tiles * splits)


# ------------------------------------------------------------------ wrappers

def _check(x, w, *more) -> bool:
    """Validate; True for CUDA tensors (launch), False for CPU (twin)."""
    if x.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"3x3 conv kernels take x [B, C_in, H, W] and w "
                         f"[C_out, C_in, 3, 3]; got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"3x3 conv kernels take float32 or bfloat16 x and w "
                        f"of one dtype; got {x.dtype}, {w.dtype}")
    devs = {t.device for t in (x, w) + more if t is not None}
    if len(devs) != 1:
        raise ValueError(f"3x3 conv inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"3x3 conv kernels run on cuda (or their plain twins "
                         f"on cpu), not {dev}")
    if dev.type == "cuda" and x.shape[1] % 8:
        raise ValueError(f"C_in = {x.shape[1]}: the 3x3 conv kernels need a "
                         "multiple of 8")
    return dev.type == "cuda"


def _arg(t: Optional[torch.Tensor], dtype=None) -> Optional[torch.Tensor]:
    """Contiguous, in ``dtype`` if given, with a 16-byte aligned start
    (the kernels load weights 16 bytes at a time)."""
    if t is None:
        return None
    t = (t if dtype is None else t.to(dtype)).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _weights(w: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """The weights [C_out, C_in, 3, 3] as the kernel reads them: [C_out, 3,
    3, C_in] for the gather and float32 kernels; for the implicit GEMM,
    tiles of 128 output by 16 input channels, [C_out / 128][C_in / 16][2]
    [3][3][128][8] (zero past C_out), so that a chunk's weight tile is one
    contiguous copy. One copy a call either way."""
    if plan.kernel != "igemm":
        return _arg(w.permute(0, 2, 3, 1))
    c_out, c_in = w.shape[:2]
    tiles = -(-c_out // BM)
    if c_out % BM:
        w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, tiles * BM - c_out))
    w = w.reshape(tiles, BM, c_in // CHUNK, 2, 8, 3, 3)
    return _arg(w.permute(0, 2, 3, 5, 6, 1, 4))


def _launch(stem: str, x, ptrs: tuple, c_out: int, plan: ConvPlan):
    """Launch ``stem`` on x [B, C_in, H, W] with its input pointers
    ``ptrs`` (x, the weights laid out by :func:`_weights`, and the fused
    kernel's a, b, bias, residual) under ``plan``; returns y."""
    bsz, c_in, h, wd = x.shape
    y = torch.empty((bsz, c_out, h, wd), dtype=x.dtype, device=x.device)
    ws = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, bsz, c_out, h, wd),
                         dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        launch(stem, *ptrs, y.data_ptr(), _ptr(ws), bsz, c_in, h, wd, c_out,
               int(x.dtype == torch.bfloat16), *plan.args())
    return y


def conv3x3_im2col(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv kernel: [B, C_in, H, W] x [C_out, C_in, 3, 3] -> [B, C_out,
    H, W] in x's dtype (forward only)."""
    if not _check(x, w, bias):
        return conv3x3_reference(x, w, bias)
    x, bias = _arg(x), _arg(bias, torch.float32)
    plan = conv_plan(x.shape[0], x.shape[1], w.shape[0], x.shape[2],
                     x.shape[3], x.dtype)
    wt = _weights(w, plan)
    return _launch("conv3x3", x, (x.data_ptr(), wt.data_ptr(), _ptr(bias)),
                   w.shape[0], plan)


def conv3x3_fused_kernel(x, a, b, w, bias=None, residual=None):
    """The fused conv kernel: conv3x3(silu(x a + b)) + bias (+ residual),
    a, b [B, C_in] float32, residual [B, C_out, H, W] (forward only)."""
    on_cuda = _check(x, w, a, b, bias, residual)
    bsz, c_in, h, wd = x.shape
    c_out = w.shape[0]
    if a.shape != (bsz, c_in) or b.shape != (bsz, c_in):
        raise ValueError(f"a, b must be [{bsz}, {c_in}]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if residual is not None and residual.shape != (bsz, c_out, h, wd):
        raise ValueError(f"residual must be [{bsz}, {c_out}, {h}, {wd}]; "
                         f"got {tuple(residual.shape)}")
    if not on_cuda:
        return fused_conv_reference(x, a, b, w, bias, residual)
    x = _arg(x)
    a, b, bias = (_arg(t, torch.float32) for t in (a, b, bias))
    residual = _arg(residual, x.dtype)
    plan = conv_plan(bsz, c_in, c_out, h, wd, x.dtype)
    wt = _weights(w, plan)
    return _launch("conv3x3_fused", x,
                   (x.data_ptr(), a.data_ptr(), b.data_ptr(), wt.data_ptr(),
                    _ptr(bias), _ptr(residual)), c_out, plan)


class Conv3x3Function(torch.autograd.Function):
    """The conv kernel forward; PyTorch's conv gradients backward (in the
    dtype of x and w, as the JAX package's XLA conv VJP)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return conv3x3_im2col(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = torch.nn.grad.conv2d_input(x.shape, w, g, padding=1) \
            if need_x else None
        dw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=1) \
            if need_w else None
        db = g.float().sum(dim=(0, 2, 3)).to(ctx.bias_dtype) \
            if need_b and ctx.has_bias else None
        return dx, dw, db


class Conv3x3FusedFunction(torch.autograd.Function):
    """The fused conv kernel forward; the JAX VJP's backward
    (conv_im2col.py:493-512): the conv's gradients in x's dtype, the SiLU
    and the affine in float32, each gradient only where asked for."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias, residual):
        ctx.save_for_backward(x, a, b, w)
        ctx.dtypes = tuple(None if t is None else t.dtype
                           for t in (bias, residual))
        return conv3x3_fused_kernel(x, a, b, w, bias, residual)

    @staticmethod
    def backward(ctx, g):
        x, a, b, w = ctx.saved_tensors
        need_x, need_a, need_b, need_w, need_bias, need_res = \
            ctx.needs_input_grad
        g = g.to(x.dtype)
        u = x.float() * a[:, :, None, None] + b[:, :, None, None]
        s = torch.sigmoid(u)
        dx = da = db = dw = None
        if need_w:
            dw = torch.nn.grad.conv2d_weight((u * s).to(x.dtype), w.shape, g,
                                             padding=1)
        if need_x or need_a or need_b:
            dh = torch.nn.grad.conv2d_input(x.shape, w, g, padding=1)
            du = dh.float() * (s * (1 + u * (1 - s)))
            if need_x:
                dx = (du * a[:, :, None, None]).to(x.dtype)
            if need_a:
                da = (du * x.float()).sum(dim=(2, 3)).to(a.dtype)
            if need_b:
                db = du.sum(dim=(2, 3)).to(b.dtype)
        dbias = g.float().sum(dim=(0, 2, 3)).to(ctx.dtypes[0]) \
            if need_bias else None
        dres = g.to(ctx.dtypes[1]) if need_res else None
        return dx, da, db, dw, dbias, dres


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv + bias through the conv kernel (its twin on
    CPU tensors), differentiable."""
    return Conv3x3Function.apply(x, w, bias)


def conv3x3_fused(x, a, b, w, bias=None, residual=None) -> torch.Tensor:
    """silu(x a + b) -> 3x3 SAME conv -> + bias (+ residual) through the
    fused conv kernel (its twin on CPU tensors), differentiable."""
    return Conv3x3FusedFunction.apply(x, a, b, w, bias, residual)
