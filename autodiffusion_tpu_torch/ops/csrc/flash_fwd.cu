// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel autodiffusion_tpu/ops/flash_attention.py::_attn_kernel
// (dispatched by _flash_forward): o = softmax(q k^T / sqrt(D)) v by online
// softmax, plus the per-row float32 logsumexp the backward needs, for q
// [N, T, D] and k, v [N, S, D], D in {16, 32, 64, 80, 128} (D = 512 is
// flash_fwd_wide.cu; the kernels themselves are in flash_fwd.cuh).
//
// Bound on this card: at the ADM-64 shapes (D = 64, T = S = 1024) and the SD
// 32x32 level (D = 80, T = S = 1024) the work is 4 T S D operations per head
// against (3 + 1) T D elements moved, far above the H100's operations-per-
// byte ridge, so it is bound by operations. The [T, S] logits never reach
// device memory: a block keeps 64 query rows resident, streams K and V
// through shared memory a tile at a time, and carries the running max, sum
// and accumulator in float32.
#include "flash_fwd.cuh"

extern "C" int adt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             int n, int t_len, int s_len, int head_dim, int is_bf16,
                             float scale, void* stream) {
  if (n == 0 || t_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: ADT_LAUNCH_FWD(16, is_bf16); break;
    case 32: ADT_LAUNCH_FWD(32, is_bf16); break;
    case 64: ADT_LAUNCH_FWD(64, is_bf16); break;
    case 80: ADT_LAUNCH_FWD(80, is_bf16); break;
    case 128: ADT_LAUNCH_FWD(128, is_bf16); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
