"""K3: decode-step KV-cache write (counterpart of
`llm_inference_tpu/ops/pallas/kv_write.py:write_token`).

`write_token` writes one new K and V row per sequence into the stacked
cache [L, B, Hkv, S, D] at slot min(offsets[b], S-1), in place. CUDA
tensors go through the kernel `csrc/kv_write.cu`; CPU tensors through
`write_token_ref`, its plain PyTorch version.
"""

from __future__ import annotations

import torch

# kernel launches made by write_token (the plain version is not counted)
launches = 0


def write_token_ref(k_all, v_all, layer: int, k_new, v_new, offsets):
    """Plain version. k_new/v_new: [B, Hkv, 1, D]; offsets: [B] int."""
    B = k_new.shape[0]
    S = k_all.shape[3]
    off = torch.clamp(offsets.reshape(B).long(), 0, S - 1)
    rows = torch.arange(B, device=k_all.device)
    k_all[layer][rows, :, off] = k_new[:, :, 0].to(k_all.dtype)
    v_all[layer][rows, :, off] = v_new[:, :, 0].to(v_all.dtype)
    return k_all, v_all


def write_token(k_all, v_all, layer: int, k_new, v_new, offsets):
    """Write ONE new token per sequence into [L, B, Hkv, S, D] caches, in
    place; returns the same cache tensors."""
    if not k_all.is_cuda:
        return write_token_ref(k_all, v_all, layer, k_new, v_new, offsets)
    global launches
    from llm_inference_tpu_torch.ops.kernels import _build
    L, B, Hkv, S, D = k_all.shape
    if not (k_all.is_contiguous() and v_all.is_contiguous()
            and v_all.shape == k_all.shape and v_all.dtype == k_all.dtype):
        raise ValueError("K3 needs two contiguous caches of one shape/dtype")
    kn = k_new.to(k_all.dtype).reshape(B, Hkv, D).contiguous()
    vn = v_new.to(k_all.dtype).reshape(B, Hkv, D).contiguous()
    off = offsets.reshape(B).to(torch.int32).contiguous()
    row_bytes = D * k_all.element_size()
    if row_bytes % 16:
        raise ValueError(f"K3 copies 16-byte vectors; row is {row_bytes} B")
    layer_bytes = B * Hkv * S * row_bytes
    code = _build.lib().kv_write_launch(
        k_all.data_ptr() + layer * layer_bytes,
        v_all.data_ptr() + layer * layer_bytes,
        kn.data_ptr(), vn.data_ptr(), off.data_ptr(), B, Hkv, S, row_bytes,
        torch.cuda.current_stream(k_all.device).cuda_stream)
    _build.check(code, "kv_write")
    launches += 1
    return k_all, v_all
