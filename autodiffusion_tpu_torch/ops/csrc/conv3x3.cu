// 3x3 stride-1 SAME convolution + bias for Hopper (sm_90a), plain C
// interface: the TPU kernel autodiffusion_tpu/ops/conv_im2col.py::_conv_kernel
// as an implicit GEMM over an NCHW input (design and bound in conv3x3.cuh).
#include "conv3x3.cuh"

// x [B, C_in, H, W], w [C_out, 3, 3, C_in], y [B, C_out, H, W], all float32
// or all bfloat16; bias [C_out] float32 or null; ws the float32 split-K
// workspace [splits, B, C_out, H, W] (null unless splits > 1). The plan
// (nt .. chunks_per_split) is conv3x3.cuh's Plan, nt = 0 for the gather
// kernels. C_in % 8 == 0 (16-byte weight loads); -1 for a shape or plan
// without a kernel.
extern "C" int adt_conv3x3(const void* x, const void* w, const float* bias, void* y, float* ws,
                           int b, int c_in, int h, int w_dim, int c_out, int is_bf16, int nt,
                           int tw, int rows, int packed, int stages, int splits,
                           int chunks_per_split, void* stream) {
  if (b == 0 || c_out == 0 || h == 0 || w_dim == 0) return 0;
  if (c_in % 8) return -1;
  adt::conv::Params p{x,    w,     bias,   nullptr, nullptr,         nullptr, y, ws,
                      c_in, h,     w_dim,  c_out,   h * w_dim,       9 * c_in, 0};
  const adt::conv::Plan plan{nt, tw, rows, packed, stages, splits, chunks_per_split};
  return adt::conv::launch<false, false>(p, b, is_bf16, plan, static_cast<cudaStream_t>(stream));
}
