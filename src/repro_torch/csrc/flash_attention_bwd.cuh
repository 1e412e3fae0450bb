// The argument block of the flash-attention backward, one layout for both
// routes (flash_attention_bwd.cu: `bwd_fma`; flash_attention_bwd_wgmma.cu:
// `bwd_wgmma`), packed by kernels/flash_attention.py (_BWD_ARGS).

#pragma once

struct BwdArgs {
  const void* q;        // (b, hq, sq, dh)
  const void* k;        // (b, hkv, skv, dh)
  const void* v;        // (b, hkv, skv, dh)
  const void* dout;     // (b, hq, sq, dh)
  void* dq;             // (b, hq, sq, dh) contiguous
  void* dk;             // (b, hkv, skv, dh) contiguous
  void* dv;             // (b, hkv, skv, dh) contiguous
  const float* lse;     // (b, hq, sq) the forward's log-sum-exp, -inf on a
                        // row with no kept key
  float* delta;         // (b, hq, sq) workspace: D = rowsum(P o dP)
  void* stream;
  // strides in elements of the batch, head and position axes
  long long st_q[3], st_k[3], st_v[3], st_do[3];
  int b, hq, hkv, sq, skv, dh, causal, has_window, window, is_bf16;
  double scale;
};
