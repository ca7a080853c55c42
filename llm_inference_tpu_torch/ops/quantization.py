"""Weight-only quantization, symmetric: INT8 per-channel and INT4
(per-channel or grouped along K), and the INT8 and INT4 KV-cache
quantizers.

Counterpart of `llm_inference_tpu/ops/quantization.py` (QTensor :27,
quantize :117, dequantize :314, qmatmul_ref :328, quantize_kv :413,
dequantize_kv :421, quantize_kv4 :425, unpack_kv4 :449, dequantize_kv4
:457). Codes and scales are bit-identical to the JAX
package for the same float32 weights: both divide in float32 and round
half to even.

A weight is [in_features K, out_features N] (activations right-multiply),
but its codes are stored transposed, one K-contiguous row per output
column, the layout in which the CUDA GEMVs (ops/kernels/quant_matmul.py,
layer_tail) stream a column with 16-byte loads:

- INT8: q int8 [..., N, K]; scale float32 [..., 1, N] (one per column).
- INT4: q int8 [..., N, K/2], two K-adjacent codes per byte — code 2j in
  the low nibble, code 2j+1 in the high nibble, both two's complement — so
  one 16-byte load carries 32 consecutive codes of a column; scale float32
  [..., N, G] with G = K / group_size groups (G = 1 per-channel), one
  column's G scales contiguous, so the lanes of a warp that stream
  neighbouring K chunks of a column read neighbouring scales.

The JAX package's column-blocked layouts ([N/bn, K', bn], and for int4 the
N-pair packing of columns j and j + bn/2 in one byte for the TPU matrix
unit's difference of dots) exist for the TPU and are not copied.
The JAX package's row-major split-half int4 layout, in one pack block or
in one block per tensor-parallel rank, is read (`from_split_half`), not
served. Asymmetric and grouped int8 weights raise
NotImplementedError until they are ported.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QTensor:
    """Quantized weight, optionally stacked over a leading layer axis."""
    q: torch.Tensor            # int8 [..., N, K] or packed int4 [..., N, K/2]
    scale: torch.Tensor        # float32 [..., 1, N] (int8) / [..., N, G] (int4)
    bits: int = 8

    @property
    def in_features(self) -> int:
        return self.q.shape[-1] * (2 if self.bits == 4 else 1)

    @property
    def out_features(self) -> int:
        return self.q.shape[-2]

    @property
    def shape(self):
        return (self.in_features, self.out_features)

    @property
    def stacked(self) -> bool:
        return self.q.dim() == 3

    @property
    def groups(self) -> int:
        """Scale groups along K (1 = per-channel)."""
        return self.scale.shape[-1] if self.bits == 4 else 1

    @property
    def group_size(self) -> int:
        return self.in_features // self.groups

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, q=self.q.to(device),
                                   scale=self.scale.to(device))

    def layer(self, idx: int) -> "QTensor":
        """One layer of a stacked QTensor (views, no copy)."""
        return dataclasses.replace(self, q=self.q[idx], scale=self.scale[idx])


def cat_columns(qts) -> QTensor:
    """QTensors of one format side by side along the output columns (the
    fused wqkv / w_gateup weights)."""
    bits = qts[0].bits
    if any(t.bits != bits for t in qts):
        raise ValueError("cannot fuse weights of different bit widths")
    # codes are [.., N, K']: columns are rows; int8 scales [.., 1, N] put
    # the columns last, int4 scales [.., N, G] second to last
    return QTensor(q=torch.cat([t.q for t in qts], dim=-2),
                   scale=torch.cat([t.scale for t in qts],
                                   dim=-2 if bits == 4 else -1),
                   bits=bits)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Codes in [-8, 7] [..., K] (any integer dtype) → int8 [..., K/2]:
    code 2j in the low nibble of byte j, code 2j+1 in the high nibble."""
    c = codes.to(torch.int32)
    v = (c[..., 0::2] & 0xF) | ((c[..., 1::2] & 0xF) << 4)    # [0, 255]
    return torch.where(v > 127, v - 256, v).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: int8 [..., K/2] → int8 codes [..., K]."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8                                   # sign-extend
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def from_split_half(q: torch.Tensor, scale: torch.Tensor,
                    block_rows: int = 0) -> QTensor:
    """The JAX package's row-major int4 weight [..., K/2, N], with scales
    [..., G, N], as the port's QTensor. Its packed rows come in pack
    blocks of `block_rows` (0: one block of K/2, a single-device weight;
    K/2/tp for a weight the JAX package row-shards over tp ranks,
    quantize_params(row_shards=tp)): packed row r of a block holds the
    block's row r in its low nibble and its row r + block_rows in the high
    one."""
    P, N = q.shape[-2], q.shape[-1]
    br = block_rows or P
    if P % br:
        raise ValueError(f"{P} packed rows do not split into pack blocks "
                         f"of {br}")
    p = q.to(torch.int32).reshape(*q.shape[:-2], P // br, br, N)
    lo = ((p & 0xF) ^ 8) - 8                           # rows r of a block
    hi = (((p >> 4) & 0xF) ^ 8) - 8                    # rows r + br
    codes = torch.cat([lo, hi], dim=-2).reshape(*q.shape[:-2], 2 * P, N)
    return QTensor(q=pack_int4(codes.transpose(-1, -2)),
                   scale=scale.to(torch.float32).transpose(-1, -2)
                   .contiguous(), bits=4)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c, an IEEE float32 division on every device. (On CUDA, PyTorch
    computes a tensor divided by a Python scalar as a times 1/c, which can
    differ in the last bit; a tensor divisor takes the true division.)"""
    return a / torch.full_like(a, c)


def _unsupported(bits: int, group_size: int, asymmetric: bool) -> None:
    if asymmetric or bits not in (4, 8) or (bits == 8 and group_size > 0):
        raise NotImplementedError(
            f"bits={bits} group_size={group_size} asymmetric={asymmetric}: "
            "only symmetric int8 per-channel and int4 (per-channel or "
            "grouped) weights are ported")


def quantize(w: torch.Tensor, bits: int = 8, group_size: int = 0,
             asymmetric: bool = False) -> QTensor:
    """Symmetric quantization of a [K, N] weight: per (group, column)
    scale = max(max|w| / qmax, 1e-8) and q = clip(round(w / scale),
    -qmax - 1, qmax), qmax = 127 (int8) or 7 (int4)."""
    if w.dim() != 2:
        raise ValueError(f"expected a 2-D weight, got {tuple(w.shape)}")
    K, N = w.shape
    # a group as wide as K is one group per column: per-channel
    gs = group_size if 0 < group_size < K else 0
    _unsupported(bits, gs, asymmetric)
    if gs and K % gs:
        raise ValueError(f"K={K} is not a multiple of group_size={gs}")
    G = K // gs if gs else 1
    qmax = float(2 ** (bits - 1) - 1)
    w32 = w.to(torch.float32).reshape(G, K // G, N)
    absmax = w32.abs().amax(dim=1, keepdim=True)                 # [G, 1, N]
    scale = torch.clamp(_div(absmax, qmax), min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -qmax - 1, qmax)
    q = q.reshape(K, N).to(torch.int8).T.contiguous()           # [N, K]
    if bits == 8:
        return QTensor(q=q, scale=scale.reshape(1, N))
    return QTensor(q=pack_int4(q), scale=scale.reshape(G, N).T.contiguous(),
                   bits=4)


def codes(qt: QTensor) -> torch.Tensor:
    """int8 codes [..., N, K] (int4 unpacked)."""
    return unpack_int4(qt.q) if qt.bits == 4 else qt.q


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Dense [..., K, N] weight: code · scale."""
    c = codes(qt).to(torch.float32)                              # [.., N, K]
    if qt.bits == 4:
        *lead, N, K = c.shape
        G = qt.groups
        w = (c.reshape(*lead, N, G, K // G) * qt.scale[..., None]
             ).reshape(*lead, N, K)
    else:
        w = c * qt.scale.transpose(-1, -2)
    return w.transpose(-1, -2).to(dtype)


def qmatmul_ref(x: torch.Tensor, qt: QTensor, dtype=None) -> torch.Tensor:
    """x [..., K] @ dequant(W) for one (unstacked) weight, as the JAX
    package's qmatmul_ref: per-channel, the dot runs on bf16 x against the
    raw codes with float32 accumulation and the column scale hits the
    output; grouped, float32 x meets each group's codes and the group's
    scale hits that partial dot before the groups are summed."""
    dtype = dtype or x.dtype
    c = codes(qt).to(torch.float32)                              # [N, K]
    if qt.groups == 1:
        y = x.to(torch.bfloat16).to(torch.float32) @ c.T
        return (y * qt.scale.reshape(-1)).to(dtype)
    N, K = c.shape
    G = qt.groups
    xg = x.to(torch.float32).reshape(*x.shape[:-1], G, K // G)
    partial = torch.einsum("...gk,ngk->...gn", xg, c.reshape(N, G, K // G))
    return (partial * qt.scale.T).sum(dim=-2).to(dtype)


# ---------------------------------------------------------------------------
# KV-cache INT8 quantization (per-token, per-head scales)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor):
    """KV entries [..., D] → (int8 codes [..., D], float32 scale [..., 1]):
    scale = max(max|x| / 127, 1e-8), q = clip(round(x / scale))."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(_div(x32.abs().amax(dim=-1, keepdim=True), 127.0),
                        min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -128, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def quantize_kv4(x: torch.Tensor):
    """KV entries [..., D] → (packed int8 codes [..., D/2], float32 scale
    [..., 1]): scale = max(max|x| / 7, 1e-8), q = clip(round(x / scale),
    -8, 7). Split-half packing along D with the offset-lo encoding: byte d
    holds dim d + 8 (unsigned, low nibble) and dim d + D/2 (signed, high
    nibble), so the signed byte is 16·hi + lo_u and hi = byte >> 4."""
    D = x.shape[-1]
    if D % 2:
        raise ValueError(f"int4 KV packing needs an even head_dim, got {D}")
    x32 = x.to(torch.float32)
    scale = torch.clamp(_div(x32.abs().amax(dim=-1, keepdim=True), 7.0),
                        min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -8, 7)
    # the signed byte 16·hi + lo_u, exact in float32 and in [-128, 127]
    packed = q[..., D // 2:] * 16 + (q[..., :D // 2] + 8)
    return packed.to(torch.int8), scale


def unpack_kv4(packed: torch.Tensor) -> torch.Tensor:
    """Packed int4 KV codes [..., D/2] → int8 values [..., D] (split-half
    order, offset-lo encoding; see quantize_kv4)."""
    p = packed.to(torch.int32)
    return torch.cat([(p & 0xF) - 8, p >> 4], dim=-1).to(torch.int8)


def dequantize_kv4(packed: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    return (unpack_kv4(packed).to(torch.float32) * scale).to(dtype)
