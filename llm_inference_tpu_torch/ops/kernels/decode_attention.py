"""K2: single-token GQA attention over the stacked dense cache, bf16 or
int8 codes with slot-major scales, and K5: the same over an int4 cache's
packed codes (counterparts of
`llm_inference_tpu/ops/pallas/decode_attention.py`, `_decode_attn` and
`_decode_attn4`).

CUDA tensors go through `csrc/decode_attention.cu`; CPU tensors through
`decode_attention_ref`, its plain PyTorch version.
"""

from __future__ import annotations

import torch

from llm_inference_tpu_torch.ops.quantization import unpack_kv4

NEG_INF = -1e30
_MAX_S = 16384
_MAX_G = 8
# the CUDA kernel splits each (sequence, kv head)'s slots over blocks, at
# most as many in all as the card holds at once (two a streaming
# multiprocessor: 256 threads of at most 128 registers), and merges their
# softmax states
_BLOCKS_PER_SM = 2
# ... and at least as many that no block walks more than this many slots
# of the cache (positions differ between sequences: a block of a long one
# must not hold up the rest of the step)
_MAX_SHARE = 512
_done = {}      # per device: the kernel's zeroed merge counters
_part = {}      # per device: the float32 scratch of the split merge
_sms = {}       # per device: its streaming multiprocessors
_tiles = {}     # (D, cache kind): slots of the kernel's tile

# kernel launches made by decode_attention: K2 (bf16 and int8 caches) and
# K5 (int4 caches); the plain version is not counted
launches = 0
int4_launches = 0


def supports(q_shape, S: int) -> bool:
    """Whether the kernel handles this case (else ops.attention) — the JAX
    package's gate, decode_attention.py:618-621."""
    B, T, Hq, D = q_shape
    return T == 1 and S <= _MAX_S and D in (64, 128, 256) and S % 128 == 0


def decode_attention_ref(q, k_all, v_all, layer: int, positions,
                         scale: float, logit_softcap: float = 0.0,
                         window: int = 0, k_scale=None, v_scale=None):
    """Plain version: bf16 q, K and V (or int8 codes), float32 softmax,
    bf16 output [B, Hkv, G, D]. With an int8 cache the scores take
    k_scale[slot] after the score scale, l sums p before the V scale, and
    p · v_scale[slot] is rounded to bf16 before the product with the codes
    (decode_attention.py:259-263, 280-292); without, p itself is rounded.
    An int4 cache (packed [.., D/2] codes) unpacks to signed values and
    keeps q and p · v_scale in float32, as the TPU kernel's float32 dots do
    (decode_attention.py:334, 392-415). Slots outside (pos - window, pos]
    are masked and their V (and V scale) zeroed (a kernel never reads them,
    so NaN there must not leak)."""
    B, _, Hq, D = q.shape
    Hkv, S = k_all.shape[2], k_all.shape[3]
    G = Hq // Hkv
    f32, bf16 = torch.float32, torch.bfloat16
    packed = k_all.shape[-1] * 2 == D
    if packed:
        qg = q.reshape(B, Hkv, G, D).to(f32)
        k = unpack_kv4(k_all[layer]).to(f32)                 # [B, Hkv, S, D]
        v = unpack_kv4(v_all[layer]).to(f32)
    else:
        qg = q.reshape(B, Hkv, G, D).to(bf16).to(f32)
        k = k_all[layer].to(bf16).to(f32)
        v = v_all[layer].to(bf16).to(f32)
    pos = positions.reshape(B, 1).long()
    slot = torch.arange(S, device=q.device)[None, :]
    ok = slot <= pos
    if window > 0:
        ok &= slot > pos - window
    ok = ok[:, None, None, :]                                # [B, 1, 1, S]
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k) * scale
    if k_scale is not None:     # [L, B, S, Hkv] slot-major → [B, Hkv, 1, S]
        scores = scores * k_scale[layer].transpose(1, 2)[:, :, None, :]
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=f32, device=q.device)
    if v_scale is not None:
        vs = v_scale[layer].transpose(1, 2)[:, :, None, :]
        p = p * torch.where(ok, vs, zero)
    v = torch.where(ok[:, :, 0, :, None], v, zero)
    if not packed:
        p = p.to(bf16).to(f32)
    acc = torch.einsum("bhgs,bhsd->bhgd", p, v)
    return (acc / l).to(bf16)


def splits(B: int, Hkv: int, S: int, tile: int, sms: int) -> int:
    """Blocks a (sequence, kv head) for a card of `sms` SMs and a kernel
    tile of `tile` slots: as many as fill one wave of the card's
    _BLOCKS_PER_SM·sms resident blocks without starting a second (on an
    H100, 9 splits of 32 heads leave 24 blocks for a second wave and take a
    quarter longer than 8), but at least enough that a block walks at most
    _MAX_SHARE slots of the cache, and no split of the S-slot cache shorter
    than two tiles (so that a full share has a tile in flight behind the
    one computed). The positions do not enter (reading them would sync the
    host); a block whose share of the live slots is empty leaves a state of
    weight 0 and ends at once."""
    want = max(_BLOCKS_PER_SM * sms // (B * Hkv), -(-S // _MAX_SHARE))
    return max(1, min(want, S // (2 * tile)))


def scratch_floats(B: int, Hkv: int, G: int, D: int, nsplit: int) -> int:
    """Float32 scratch of the split merge: a [G, D] accumulator, G maxima
    and G sums for each of the B·Hkv·nsplit blocks."""
    return B * Hkv * nsplit * G * (D + 2)


def tile_slots(D: int, kind: int) -> int:
    """Slots of the kernel's tile for head size D and cache kind (0 bf16,
    1 int8, 2 packed int4), as the kernel's source sets it."""
    key = (D, kind)
    if key not in _tiles:
        from llm_inference_tpu_torch.ops.kernels import _build
        _tiles[key] = _build.lib().decode_attn_tile_slots(D, kind)
    return _tiles[key]


def split_buffers(device, B: int, Hkv: int, G: int, S: int, D: int,
                  kind: int):
    """(nsplit, part, done) for a launch on `device` (a CUDA device) over a
    cache of `kind`: nsplit from `splits` with the kernel's tile and the
    card's SM count, and pointers to the device's float32 scratch and
    zeroed int32 merge counters, grown as needed and kept between calls
    (launches on one stream run in order, and the kernel leaves the
    counters zero); None for both when nsplit is 1."""
    sms = _sms.get(device)
    if sms is None:
        sms = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    nsplit = splits(B, Hkv, S, tile_slots(D, kind), sms)
    if nsplit == 1:
        return 1, None, None
    floats = scratch_floats(B, Hkv, G, D, nsplit)
    part = _part.get(device)
    if part is None or part.numel() < floats:
        part = _part[device] = torch.empty(floats, dtype=torch.float32,
                                           device=device)
    done = _done.get(device)
    if done is None or done.numel() < B * Hkv:
        done = _done[device] = torch.zeros(B * Hkv, dtype=torch.int32,
                                           device=device)
    return nsplit, part.data_ptr(), done.data_ptr()


def decode_attention(q, k_all, v_all, layer: int, positions,
                     scale: float | None = None, logit_softcap: float = 0.0,
                     window: int = 0, k_scale=None, v_scale=None):
    """q [B, 1, Hq, D]; k_all/v_all [L, B, Hkv, S, Dc] with this step's
    token already written (bf16, int8 codes, or int4 packed codes with
    Dc = D/2, the quantized ones with k_scale/v_scale [L, B, S, Hkv]
    float32); positions [B] (or [B, 1]) absolute position of the token.
    Returns [B, 1, Hq, D] in q.dtype. Callers check `supports` first."""
    B, T, Hq, D = q.shape
    if T != 1:
        raise ValueError("decode attention is single-step")
    L, _, Hkv, S, _ = k_all.shape
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    window = int(window or 0)
    quantized = not k_all.is_floating_point()
    packed = quantized and k_all.shape[-1] * 2 == D
    if quantized and (k_scale is None or v_scale is None):
        raise ValueError("a quantized KV cache needs its k_scale and v_scale")
    if not k_all.is_cuda:
        out = decode_attention_ref(q, k_all, v_all, layer, positions, scale,
                                   logit_softcap, window, k_scale, v_scale)
        return out.reshape(B, 1, Hq, D).to(q.dtype)
    global launches, int4_launches
    from llm_inference_tpu_torch.ops.kernels import _build
    what = "K5" if packed else "K2"
    code_dtype = torch.int8 if quantized else torch.bfloat16
    if k_all.dtype != code_dtype or v_all.dtype != code_dtype:
        raise TypeError(f"{what} takes a bf16, int8 or packed int4 cache, "
                        f"got {k_all.dtype}/{v_all.dtype}")
    if packed and q.dtype != torch.bfloat16:
        # the TPU kernel dots q at its own precision over an int4 cache
        raise TypeError(f"K5 takes a bf16 q, got {q.dtype}")
    Dc = D // 2 if packed else D
    if not (supports(q.shape, S) and G <= _MAX_G and k_all.is_contiguous()
            and v_all.is_contiguous() and k_all.shape[-1] == Dc
            and v_all.shape == k_all.shape):
        raise ValueError(f"{what} does not take q {tuple(q.shape)} over a "
                         f"cache {tuple(k_all.shape)}")
    ks = vs = None
    if quantized:
        if not (k_scale.dtype == v_scale.dtype == torch.float32
                and k_scale.shape == v_scale.shape == (L, B, S, Hkv)
                and k_scale.is_contiguous() and v_scale.is_contiguous()):
            raise ValueError("K2 takes contiguous float32 scales "
                             f"[L, B, S, Hkv] = {(L, B, S, Hkv)}")
        scale_bytes = B * S * Hkv * 4
        ks = k_scale.data_ptr() + layer * scale_bytes
        vs = v_scale.data_ptr() + layer * scale_bytes
    qg = q.to(torch.bfloat16).reshape(B, Hkv, G, D).contiguous()
    pos = positions.reshape(B).to(torch.int32).contiguous()
    out = torch.empty((B, Hkv, G, D), dtype=torch.bfloat16, device=q.device)
    layer_bytes = B * Hkv * S * Dc * k_all.element_size()
    kind = 2 if packed else 1 if quantized else 0
    nsplit, part, done = split_buffers(q.device, B, Hkv, G, S, D, kind)
    code = _build.lib().decode_attn_launch(
        qg.data_ptr(), k_all.data_ptr() + layer * layer_bytes,
        v_all.data_ptr() + layer * layer_bytes, ks, vs, pos.data_ptr(),
        out.data_ptr(), part, done, B, Hkv, G, S, D, kind, nsplit,
        float(scale), float(logit_softcap), window,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "decode_attention")
    if packed:
        int4_launches += 1
    else:
        launches += 1
    return out.reshape(B, 1, Hq, D).to(q.dtype)
