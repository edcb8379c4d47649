"""Wire decode and canonical ntHash of every window, in plain PyTorch (port
of ntcard_tpu/ops/nthash.py).

These are XLA code in the JAX package, not Pallas kernels, so they stay
plain tensor code here. On the main paths only the wire decode runs on the
card as tensor code; hashing, sampling and bucketing run in the hand kernel
K1 (ops/sketch_idx.py), and hashing and the HLL register update in K5
(ops/hll.py), whose plain versions are built from
:func:`window_hashes_doubling`, :func:`make_sketch_emit` and
:func:`make_hll_emit` below.

Layout follows the JAX package: decoded code streams are position-major
``[L, B]`` (chunk row b is column b). Hashes are uint64 bit patterns in
int64 tensors (ops/u64.py). Spaced seeds (``mask_positions``, a single k)
strip the masked positions' seed contributions before the canonical min.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ntcard_tpu_torch import constants as C
from ntcard_tpu_torch.ops import u64
from ntcard_tpu_torch.ops.rotations import comp_seed_table, seed_table, srol_n, strip_tables

N_CODE = C.N
_I64_MAX = (1 << 63) - 1


def unpack_rows(codes: torch.Tensor) -> torch.Tensor:
    """Inverse of the nibble wire (io/packing.py): [B/2, L] uint8 -> [L, B]
    code stream (hi nibble = chunk row b, lo nibble = row b + B/2)."""
    p = codes.T
    return torch.cat([p >> 4, p & 0x0F], dim=1)


def _set_n(cT: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, ok: torch.Tensor):
    """cT[rows[ok], cols[ok]] = N without a host sync: positions that are not
    ``ok`` go to one dump slot past the end (JAX's mode="drop" scatter)."""
    R, B = cT.shape
    lin = torch.where(ok, rows * B + cols, R * B).reshape(-1)
    buf = torch.cat([cT.reshape(-1), cT.new_zeros(1)])
    buf.index_fill_(0, lin, N_CODE)
    return buf[:-1].view(R, B)


def _stream_positions(adv: torch.Tensor) -> torch.Tensor:
    """Delta sidecar [nslots/128, 128] (stream runs down the columns) ->
    absolute stream positions: per-column cumsum plus the exclusive prefix
    of column totals."""
    colsum = torch.cumsum(adv, dim=0)
    totals = colsum[-1]
    offs = torch.cumsum(totals, dim=0) - totals
    return colsum + offs[None, :]


def _unpack_2bit(p: torch.Tensor) -> torch.Tensor:
    """[S, B/4] uint8 of four 2-bit codes -> [S, B]."""
    return torch.cat([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3], dim=1)


def unpack_quad(wire: torch.Tensor) -> torch.Tensor:
    """Inverse of the quad wire (io/packing.py): [B/4 + B/64, L] uint8 quad wire
    -> [L, B] code stream (2-bit codes, N restored from the uint16 delta
    sidecar)."""
    R, L = wire.shape
    if R % 17:
        raise ValueError(f"quad wire rows ({R}) must be a multiple of 17")
    B = R * 64 // 17
    g = B // 4
    cT = _unpack_2bit(wire[:g].T)
    tail = wire[g:].reshape(-1, 2).to(torch.int64)  # little-endian uint16 pairs
    A = (tail[:, 0] | (tail[:, 1] << 8)).reshape(-1, 128)
    adv = torch.where(A == 0xFFFF, 65533, torch.where(A == 0xFFFE, 0, A))
    mark = A < 0xFFFE
    pos = _stream_positions(adv)
    bi = pos // L
    return _set_n(cT, pos % L, bi, mark & (bi < B))


def unpack_quad2(wire: torch.Tensor, halo: int) -> torch.Tensor:
    """Inverse of the quad2 wire (io/packing.py): [B/4 + B/128 + 1, S] uint8
    quad2 wire -> [S + halo, B] code stream (owned spans, N marks from the
    uint8 sidecar, the all-N fill tail, and each chunk's halo rebuilt from
    the next chunk's head; only the last chunk's halo travels)."""
    R, S = wire.shape
    B = (R - 1) * 128 // 33  # R = B/4 + B/128 + 1
    g = B // 4
    drows = B // 128
    cT = _unpack_2bit(wire[:g].T)  # [S, B] owned spans
    A = wire[g : g + drows].reshape(-1).to(torch.int64).reshape(-1, 128)
    is_mark = A <= 239
    adv = torch.where(is_mark, A, torch.where(A >= 254, 0, (A - 239) * 240))
    pos = _stream_positions(adv)
    bi = pos // S
    cT = _set_n(cT, pos % S, bi, is_mark & (bi < B))
    # fill entry (254): every stream position after it is N
    fill_from = torch.where(A == 254, pos, _I64_MAX).min()
    sub = torch.arange(S, device=wire.device)[:, None]
    lane = torch.arange(B, device=wire.device)[None, :]
    cT = torch.where(lane * S + sub > fill_from, N_CODE, cT).to(torch.uint8)
    head = cT[:halo]
    tail = wire[g + drows, :halo].reshape(halo, 1)  # raw codes incl. N
    shifted = torch.cat([head[:, 1:], tail], dim=1)
    return torch.cat([cT, shifted], dim=0)


def codes_T(codes: torch.Tensor, packed) -> torch.Tensor:
    """[*, L] wire or code batch -> [L, B] code stream. ``packed``: False =
    raw [B, L] codes, True/"nibble" = nibble wire, "quad" = quad wire,
    "quad2:<halo>" = quad2 wire."""
    if isinstance(packed, str) and packed.startswith("quad2:"):
        return unpack_quad2(codes, int(packed.split(":", 1)[1]))
    if packed == "quad":
        return unpack_quad(codes)
    if packed:
        return unpack_rows(codes)
    return codes.T


def window_hashes_doubling(
    cT: torch.Tensor,
    ks: Sequence[int],
    stride: int,
    mask_positions: Sequence[int] | None = None,
) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """Canonical ntHash of every owned window, by window doubling.

    cT: [L, B] uint8 code stream. Returns {k: (h, valid)}, each [stride, B]:
    h the canonical hash min(F, R) as int64 bits, valid True where the
    window is N-free. A length-(a+b) window composes from its halves,

        Wf[a+b](i) = P^b(Wf[a](i)) ^ Wf[b](i+a)
        Wr[a+b](i) = Wr[a](i) ^ P^a(Wr[b](i+a)),

    from Wf[1](i) = seed(b_i) and Wr[1](i) = seed(comp b_i), exactly as
    ntcard_tpu.ops.nthash.window_hashes_doubling does. With
    ``mask_positions`` (spaced seeds, a single k) each masked position p's
    contributions P^(k-1-p)(seed(b_{i+p})) and P^p(seed(comp b_{i+p})) are
    XORed out of F and R before the min; validity stays the full-window N
    test, masked positions included (nthash_ref.spaced_kmer_hashes)."""
    if mask_positions and len(ks) != 1:
        raise ValueError("spaced seeds support a single k only (reference parity)")
    L = cT.shape[0]
    S = stride
    if S + max(ks) - 1 > L:
        raise ValueError(f"stride ({S}) + kmax ({max(ks)}) - 1 exceeds the row length ({L})")

    def shift_up(x, s):
        return torch.cat([x[s:], x.new_zeros((s,) + x.shape[1:])], dim=0)

    f1 = u64.lut5(cT, seed_table(cT.device))
    r1 = u64.lut5(cT, comp_seed_table(cT.device))
    n1 = cT == N_CODE

    def compose(fa, ra, na, la, fb, rb, nb, lb):
        f = srol_n(fa, lb) ^ shift_up(fb, la)
        r = ra ^ srol_n(shift_up(rb, la), la)
        return f, r, na | shift_up(nb, la)

    kmax = max(ks)
    pow2 = {1: (f1, r1, n1)}
    w = 1
    while 2 * w <= kmax:
        f, r, nn = pow2[w]
        pow2[2 * w] = compose(f, r, nn, w, f, r, nn, w)
        w *= 2

    out = {}
    for k in ks:
        acc, alen = None, 0
        for bit in reversed(range(k.bit_length())):
            p = 1 << bit
            if not k & p:
                continue
            if acc is None:
                acc, alen = pow2[p], p
            else:
                acc, alen = compose(*acc, alen, *pow2[p], p), alen + p
        fh, rh, has_n = acc
        fh, rh = fh[:S], rh[:S]
        if mask_positions:
            ft, rt = strip_tables(k, mask_positions, cT.device)
            for j, p in enumerate(mask_positions):
                cp = cT[p : p + S]
                fh = fh ^ u64.lut5(cp, ft[j])
                rh = rh ^ u64.lut5(cp, rt[j])
        out[k] = (u64.umin(fh, rh), ~has_n[:S])
    return out


def make_sketch_emit(s_bits: int, r_bits: int):
    """ntcard's sampling and bucketing (ntcard.cpp:132-145), as
    ntcard_tpu.ops.nthash.make_sketch_emit:

      sample 0 iff hVal >> (63-sBits) == 1       (rate 2^-(sBits+1))
      sample 1 iff hVal >> (64-sBits) == sMask   (rate 2^-sBits)
      emit idx = sample*2^rBits + (hVal & (2^rBits-1)), or the sentinel
                 2^(rBits+1) where unsampled or invalid.
    """
    if not 1 <= s_bits <= 31:
        raise ValueError(f"s_bits must be in [1,31], got {s_bits}")
    if not 1 <= r_bits <= 28:
        raise ValueError(f"r_bits must be in [1,28], got {r_bits}")
    r_buck = 1 << r_bits
    s_mask = (1 << (s_bits - 1)) - 1
    sentinel = 2 * r_buck

    def emit(h: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        hi = u64.lsr(h, 32)
        s0 = (hi >> (31 - s_bits)) == 1
        s1 = (hi >> (32 - s_bits)) == s_mask
        bucket = (h & (r_buck - 1)) + torch.where(s1, r_buck, 0)
        return torch.where(valid & (s0 | s1), bucket, sentinel).to(torch.int32)

    return emit


def sketch_scan(
    codes: torch.Tensor,
    ks: Sequence[int],
    stride: int,
    s_bits: int,
    r_bits: int,
    mask_positions: Sequence[int] | None = None,
    packed=False,
) -> Tuple[Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
    """Per k, a flat [stride*B] int32 emit stream (position-major, sentinel
    2^(r_bits+1) where no update) and the valid-window count (F1 share), as
    ntcard_tpu.ops.nthash.sketch_scan."""
    emit = make_sketch_emit(s_bits, r_bits)
    hashes = window_hashes_doubling(codes_T(codes, packed), tuple(ks), stride, mask_positions)
    idx, f1 = {}, {}
    for k in ks:
        h, valid = hashes[k]
        idx[k] = emit(h, valid).reshape(-1)
        f1[k] = valid.sum()
    return idx, f1


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each uint64 bit pattern (int64 tensor), by a binary
    search of masked logical shifts; 63 for 0, which callers mask out."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = u64.lsr(x, 64 - s) == 0  # the top s bits are all 0
        n = n + torch.where(top_zero, s, 0)
        x = torch.where(top_zero, x << s, x)
    return n


def make_hll_emit(n_bits: int):
    """nthll's register update inputs (nthll.cpp:92-97), as
    ntcard_tpu.ops.nthash.make_hll_emit: register index = h & (2^n_bits - 1);
    value = clz64(h & ~(2^n_bits - 1)), or 0 when that masked value is 0 or
    the window is invalid (a max with 0 changes nothing)."""
    if not 1 <= n_bits <= 31:
        raise ValueError(f"n_bits must be in [1,31], got {n_bits}")
    mask = (1 << n_bits) - 1

    def emit(h: torch.Tensor, valid: torch.Tensor):
        high = h & ~mask
        run0 = torch.where(valid & (high != 0), clz64(high), 0).to(torch.int32)
        return (h & mask).to(torch.int32), run0

    return emit


def hll_scan(codes: torch.Tensor, k: int, stride: int, n_bits: int):
    """Flat [stride*B] (register index, run0) of every owned window of a
    [B, L] code batch, as ntcard_tpu.ops.nthash.hll_scan on raw codes."""
    emit = make_hll_emit(n_bits)
    h, valid = window_hashes_doubling(codes.T, (k,), stride)[k]
    reg, run0 = emit(h, valid)
    return reg.reshape(-1), run0.reshape(-1)
