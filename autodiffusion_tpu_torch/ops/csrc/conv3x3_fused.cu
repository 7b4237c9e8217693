// Fused norm-act-conv for Hopper (sm_90a), plain C interface: the TPU kernel
// autodiffusion_tpu/ops/conv_im2col.py::_fused_conv_kernel,
//   y = conv3x3(silu(x a + b) cast to x's dtype) + bias (+ residual),
// with a, b the per-(sample, input channel) float32 affine that folds
// GroupNorm and FiLM, applied as the input is staged, and the bias and
// residual added to the float32 accumulator before the one cast (design
// and bound in conv3x3.cuh).
#include "conv3x3.cuh"

// x [B, C_in, H, W], w [C_out, 3, 3, C_in], residual and y [B, C_out, H, W],
// all float32 or all bfloat16; a, b [B, C_in] float32; bias [C_out] float32
// or null; residual may be null; ws and the plan as adt_conv3x3's. C_in %
// 8 == 0; -1 for a shape or plan without a kernel.
extern "C" int adt_conv3x3_fused(const void* x, const float* a, const float* b_aff,
                                 const void* w, const float* bias, const void* residual,
                                 void* y, float* ws, int b, int c_in, int h, int w_dim,
                                 int c_out, int is_bf16, int nt, int tw, int rows,
                                 int packed, int stages, int splits, int chunks_per_split, void* stream) {
  if (b == 0 || c_out == 0 || h == 0 || w_dim == 0) return 0;
  if (c_in % 8) return -1;
  adt::conv::Params p{x,    w,     bias,  a,     b_aff,     residual, y, ws,
                      c_in, h,     w_dim, c_out, h * w_dim, 9 * c_in, 0};
  const adt::conv::Plan plan{nt, tw, rows, packed, stages, splits, chunks_per_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return residual ? adt::conv::launch<true, true>(p, b, is_bf16, plan, st)
                  : adt::conv::launch<true, false>(p, b, is_bf16, plan, st);
}
