// Small-head-dim flash-attention forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel
// autodiffusion_tpu/ops/flash_attention.py::_attn_kernel_packed (dispatched
// by _flash_forward_packed): the same o, lse contract as _attn_kernel for
// head dims D <= 64. On the TPU, packing G = 128 / D heads into the 128
// lanes of the matrix unit filled the lanes a D = 40 head leaves idle. On
// Hopper the 16-deep mma step wastes only D = 40's padding to 48, so what
// carries over is the layout: the kernel reads q [B, T, H * D] and k, v
// [B, S, H * D] token-major, as the attention projections (to_q, to_k,
// to_v) produce them, and writes o [B, T, H * D] for to_out, so the four
// head transposes around an unpacked kernel disappear. One block works on
// one (batch, head, 64-query tile); lse is [B * H, T] float32.
//
// Bound on this card: at the Stable Diffusion 64x64 level (D = 40, 8 heads,
// T = 4096, S = 4096 or 77) self-attention is bound by operations (4 T S D
// per head against 4 T D elements moved); cross-attention over 77 keys by
// bytes. The row stride is H * D elements, so a tile row is D * 2 (bf16) or
// D * 4 (float32) contiguous bytes, 16-byte aligned for D % 8 == 0.
#include "flash_fwd.cuh"

// q, o [B, T, heads * head_dim]; k, v [B, S, heads * head_dim]; lse [B *
// heads, T]. raw_pad (kernel checks only) reads the padding columns of a
// head dim that is not a multiple of 16 from memory instead of zeroing
// them. -1 for a head dim without an instantiation.
extern "C" int adt_flash_fwd_packed(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int b, int heads, int t_len, int s_len,
                                    int head_dim, int is_bf16, int raw_pad, float scale,
                                    void* stream) {
  if (b == 0 || heads == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = b * heads;
  const int ld = heads * head_dim;
  switch (head_dim) {
    case 16: ADT_LAUNCH_FWD(16, 16, heads, ld, raw_pad, is_bf16); break;
    case 32: ADT_LAUNCH_FWD(32, 32, heads, ld, raw_pad, is_bf16); break;
    case 40: ADT_LAUNCH_FWD(40, 48, heads, ld, raw_pad, is_bf16); break;
    case 64: ADT_LAUNCH_FWD(64, 64, heads, ld, raw_pad, is_bf16); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
