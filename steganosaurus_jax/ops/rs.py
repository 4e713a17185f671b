"""Reed-Solomon FEC over GF(2^8) with cross-codeword interleaving.

Builds the reference roadmap's top deferred FEC item (reference
doc/TODO.md "Tier 3: Stronger FEC (Reed-Solomon or LDPC)... Add
interleaving across turtle sequence to distribute burst errors") — never
implemented upstream; the shipped payload code is Rep-7
(steganosaur.cpp:494-508). Rebuild-only wire mode, selected per stego by a
header FLAGS bit (pipeline/header.py FLAG_RS_PAYLOAD) so extraction is
self-describing; the reference binary fails closed on such stegos (wrong
payload length -> AEAD reject), same as the QIM mode.

Code: systematic RS(255, 223) — NROOTS=32 parity bytes per codeword,
t=16 correctable byte errors. Expansion 255/223 ~ 1.143x vs Rep-7's 7x:
~6.1x more payload per written bin. Against the certified channel (raw bit
BER ~0.16% at the 4K/16 KB headline => ~1.3% byte error rate) a full-length
codeword sees ~3.3 expected errors; P(>16) is ~1e-8 (Poisson tail), far
below Rep-7's residual under the same channel. The trade is real and
documented: Rep-7 tolerates up to 43% bit BER, RS(255,223) only ~6% byte
corruption — pair RS with the hard/soft/QIM<=10 writes, not deep QIM
(doc/ATTACKS.md quantifies per-mode raw BER).

Field: GF(2^8) modulo 0x11d (x^8+x^4+x^3+x^2+1), generator alpha = 2; the
generator polynomial has roots alpha^1..alpha^32 (fcr=1) — the conventional
CCSDS/QR parameterization. Position i of an n-byte codeword carries the
coefficient of x^(n-1-i) (data first, parity in the low-order tail).

Interleaving: a message is split into ceil(m/223) near-equal blocks
(shortened codewords) and the coded bytes are emitted COLUMN-MAJOR across
blocks, so a burst of consecutive corrupted walk bins lands on distinct
codewords (one byte each) instead of concentrating in one.

Hot paths (encode, syndromes, Berlekamp-Massey, Chien, Forney, and the
errors-and-erasures ladder) dispatch to the native codec (native/rs.cc,
~11x faster per 16 KB message: 23 ms -> ~2 ms) when the library is built;
this module's numpy/pure implementations are the un-built fallback and the
cross-check oracle (STEGANOSAURUS_NO_NATIVE=1 forces them).
"""

from __future__ import annotations

import numpy as np

from steganosaurus_jax import _native_loader


def _native():
    lib = _native_loader.get()
    return lib if (lib is not None and getattr(lib, "has_rs", False)) else None

RS_N = 255
RS_K = 223
NROOTS = RS_N - RS_K  # 32 parity bytes, t = 16
_T = NROOTS // 2
_PRIM = 0x11D

# --- GF(2^8) tables -------------------------------------------------------

_EXP = np.zeros(510, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _PRIM
_EXP[255:] = _EXP[:255]
del _x, _i


def gf_mul(a, b):
    """Vectorized GF(256) multiply (arrays or scalars, uint8 semantics)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = _EXP[_LOG[a] + _LOG[b]]
    return np.where((a == 0) | (b == 0), np.uint8(0), out)


def gf_inv(a):
    """Vectorized GF(256) inverse; 0 maps to 0 (callers mask)."""
    a = np.asarray(a, dtype=np.uint8)
    return np.where(a == 0, np.uint8(0), _EXP[255 - _LOG[np.maximum(a, 1)]])


def _gen_poly(nroots: int = NROOTS) -> np.ndarray:
    """Monic generator poly prod_{j=1..nroots}(x - alpha^j), highest-degree
    coefficient first."""
    g = np.array([1], dtype=np.uint8)
    for j in range(1, nroots + 1):
        root = _EXP[j]
        nxt = np.zeros(len(g) + 1, dtype=np.uint8)
        nxt[: len(g)] ^= g                       # g * x
        nxt[1:] ^= gf_mul(g, root)               # g * root
        g = nxt
    return g


_GEN = _gen_poly()
_GEN_TAIL = _GEN[1:]  # g is monic


# --- block splitting & interleaving ---------------------------------------


def n_blocks(m: int) -> int:
    """Number of RS codewords for an m-byte message."""
    return max(1, -(-m // RS_K))


def coded_len(m: int) -> int:
    """Total coded bytes for an m-byte message (data + parity, all blocks)."""
    return m + NROOTS * n_blocks(m)


def _block_sizes(m: int) -> list[int]:
    """Near-equal data sizes per block (deterministic from m alone, so the
    extractor can reconstruct the layout from the header clen)."""
    nb = n_blocks(m)
    base, extra = divmod(m, nb)
    return [base + 1] * extra + [base] * (nb - extra)


def _interleave_perm(sizes: list[int]) -> np.ndarray:
    """Permutation p with interleaved[j] = flat[p[j]], where `flat` is the
    row-major concatenation of the coded blocks (each sizes[i]+NROOTS bytes)
    and the output is the column-major (cross-block) emission order."""
    lens = np.asarray([s + NROOTS for s in sizes])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    maxlen = int(lens.max())
    cols = []
    for j in range(maxlen):
        rows = np.nonzero(lens > j)[0]
        cols.append(offs[rows] + j)
    return np.concatenate(cols)


# --- encode ----------------------------------------------------------------


def _encode_rows(data: np.ndarray, sizes: list[int]) -> np.ndarray:
    """Systematic LFSR encode. `data` is (nb, kmax) with rows right-padded by
    zeros past their size; returns (nb, NROOTS) parity. Zero-padding a
    shortened codeword's HIGH-order positions does not change its parity, so
    ragged rows can share one vectorized pass over kmax columns."""
    nb, kmax = data.shape
    state = np.zeros((nb, NROOTS), dtype=np.uint8)
    # A row of size s < kmax must feed its bytes LAST (virtual leading
    # zeros): shift each row right so all rows end together.
    shifted = np.zeros_like(data)
    for i, s in enumerate(sizes):
        if s:
            shifted[i, kmax - s:] = data[i, :s]
    for c in range(kmax):
        fb = shifted[:, c] ^ state[:, 0]
        state[:, :-1] = state[:, 1:]
        state[:, -1] = 0
        state ^= gf_mul(fb[:, None], _GEN_TAIL[None, :])
    return state


def rs_encode_interleaved(data: bytes) -> bytes:
    """Encode `data` into the interleaved RS byte stream (coded_len(m) bytes)."""
    m = len(data)
    if m == 0:
        raise ValueError("empty message")
    lib = _native()
    if lib is not None:
        return lib.rs_encode(np.frombuffer(data, dtype=np.uint8), m).tobytes()
    sizes = _block_sizes(m)
    nb = len(sizes)
    kmax = sizes[0]
    rows = np.zeros((nb, kmax), dtype=np.uint8)
    arr = np.frombuffer(data, dtype=np.uint8)
    off = 0
    for i, s in enumerate(sizes):
        rows[i, :s] = arr[off: off + s]
        off += s
    parity = _encode_rows(rows, sizes)
    flat = np.concatenate(
        [np.concatenate([rows[i, : sizes[i]], parity[i]]) for i in range(nb)]
    )
    return flat[_interleave_perm(sizes)].tobytes()


# --- decode ----------------------------------------------------------------


def _deinterleave(coded: np.ndarray, sizes: list[int]) -> np.ndarray:
    """(total,) interleaved bytes -> (nb, nmax) rows, right-padded with the
    row's virtual leading zeros on the LEFT (shortened-codeword alignment):
    row i holds [0-pad][data_i][parity_i] so every row is a full-length-
    aligned polynomial with the same root structure."""
    nb = len(sizes)
    lens = np.asarray([s + NROOTS for s in sizes])
    nmax = int(lens.max())
    perm = _interleave_perm(sizes)
    flat = np.zeros(int(lens.sum()), dtype=np.uint8)
    flat[perm] = coded
    rows = np.zeros((nb, nmax), dtype=np.uint8)
    off = 0
    for i in range(nb):
        li = int(lens[i])
        rows[i, nmax - li:] = flat[off: off + li]
        off += li
    return rows


def _syndromes(rows: np.ndarray) -> np.ndarray:
    """(nb, n) codeword rows -> (nb, NROOTS) syndromes S_j = C(alpha^j).
    Position i carries x^(n-1-i)."""
    nb, n = rows.shape
    powers = np.arange(n - 1, -1, -1, dtype=np.int64)  # exponent per column
    logc = _LOG[rows]
    nz = rows != 0
    S = np.zeros((nb, NROOTS), dtype=np.uint8)
    for j in range(1, NROOTS + 1):
        pe = (powers * j) % 255
        terms = np.where(nz, _EXP[logc + pe[None, :]], np.uint8(0))
        S[:, j - 1] = np.bitwise_xor.reduce(terms, axis=1)
    return S


def _berlekamp_massey(S: np.ndarray) -> np.ndarray:
    """Vectorized-across-blocks BM: (nb, NROOTS) syndromes -> (nb, _T+1)
    error locator Lambda (Lambda[:,0]=1), degree clamped to t."""
    nb = S.shape[0]
    ln = NROOTS + 1
    C = np.zeros((nb, ln), dtype=np.uint8)
    B = np.zeros((nb, ln), dtype=np.uint8)
    C[:, 0] = 1
    B[:, 0] = 1
    L = np.zeros(nb, dtype=np.int64)
    mshift = np.ones(nb, dtype=np.int64)
    b = np.ones(nb, dtype=np.uint8)
    idx = np.arange(ln)
    for n_ in range(NROOTS):
        # discrepancy d = sum_{j=0..n_} C[j] * S[n_-j]  (C[0]=1 term = S[n_])
        jmax = min(n_, ln - 1)
        terms = gf_mul(C[:, : jmax + 1], S[:, n_ - jmax: n_ + 1][:, ::-1])
        d = np.bitwise_xor.reduce(terms, axis=1)
        upd = d != 0
        if not upd.any():
            mshift += 1
            continue
        # x^mshift * B, per-row variable shift
        src = idx[None, :] - mshift[:, None]
        Bs = np.where(src >= 0,
                      np.take_along_axis(B, np.maximum(src, 0), axis=1),
                      np.uint8(0))
        coef = gf_mul(d, gf_inv(b))
        Cnew = C ^ gf_mul(coef[:, None], Bs)
        grow = upd & (2 * L <= n_)
        # branch: grow -> (B,b) <- (C,d), L <- n_+1-L, mshift <- 1
        B = np.where(grow[:, None], C, B)
        b = np.where(grow, d, b)
        Lg = np.where(grow, n_ + 1 - L, L)
        m_new = np.where(grow, 1, np.where(upd, mshift + 1, mshift + 1))
        C = np.where(upd[:, None], Cnew, C)
        L = Lg
        mshift = m_new
    return C[:, : _T + 1]


def _chien_forney(rows: np.ndarray, S: np.ndarray, Lam: np.ndarray):
    """Correct `rows` in place; returns (ok, nerr) per block.

    ok[i] is False when the locator's root count over the full field
    disagrees with its degree (more than t errors — undecodable)."""
    nb, n = rows.shape
    t1 = Lam.shape[1]
    deg = np.zeros(nb, dtype=np.int64)
    for j in range(t1):
        deg = np.where(Lam[:, j] != 0, j, deg)
    # Omega = S(x) * Lambda(x) mod x^NROOTS  (S(x) = S_1 + S_2 x + ...)
    Om = np.zeros((nb, NROOTS), dtype=np.uint8)
    for j in range(t1):
        lj = Lam[:, j]
        hi = NROOTS - j
        if hi <= 0:
            break
        Om[:, j:] ^= gf_mul(lj[:, None], S[:, :hi])
    # Evaluate Lambda, Lambda' (odd terms), Omega at x = alpha^{-p} for every
    # position power p = n-1-i.
    powers = np.arange(n - 1, -1, -1, dtype=np.int64)
    xinv_log = (255 - powers % 255) % 255  # log of alpha^{-p}
    lam_v = np.zeros((nb, n), dtype=np.uint8)
    lamd_v = np.zeros((nb, n), dtype=np.uint8)
    om_v = np.zeros((nb, n), dtype=np.uint8)
    for j in range(t1):
        lj = Lam[:, j]
        pe = (xinv_log * j) % 255
        term = np.where(lj[:, None] != 0,
                        _EXP[_LOG[lj][:, None] + pe[None, :]], np.uint8(0))
        lam_v ^= term
        if j % 2 == 1:  # derivative in char 2: odd-degree terms, power j-1
            ped = (xinv_log * (j - 1)) % 255
            termd = np.where(lj[:, None] != 0,
                             _EXP[_LOG[lj][:, None] + ped[None, :]],
                             np.uint8(0))
            lamd_v ^= termd
    for j in range(NROOTS):
        oj = Om[:, j]
        pe = (xinv_log * j) % 255
        om_v ^= np.where(oj[:, None] != 0,
                         _EXP[_LOG[oj][:, None] + pe[None, :]], np.uint8(0))
    errmask = lam_v == 0
    nerr = errmask.sum(axis=1)
    # Forney (fcr=1): e = Omega(Xinv) / Lambda'(Xinv)
    ev = gf_mul(om_v, gf_inv(lamd_v))
    rows ^= np.where(errmask, ev, np.uint8(0))
    ok = nerr == deg
    return ok, nerr


def rs_decode_interleaved(coded: bytes | np.ndarray, m: int):
    """Decode an interleaved stream back to the m-byte message.

    Returns (message_bytes, ok, corrected_count). When a block is
    undecodable (> t byte errors) its data bytes are returned UNCORRECTED
    and ok=False — downstream AEAD rejects, mirroring the pipeline's
    fail-to-auth philosophy (never raise on corrupt payload bits).
    """
    sizes = _block_sizes(m)
    coded = np.frombuffer(bytes(coded), dtype=np.uint8) if isinstance(
        coded, (bytes, bytearray)) else np.asarray(coded, dtype=np.uint8)
    if coded.shape[0] < coded_len(m):
        raise ValueError("coded stream shorter than coded_len(m)")
    lib = _native()
    if lib is not None:
        msg, ok, nerr = lib.rs_decode(coded[: coded_len(m)], m)
        return msg.tobytes(), bool(ok.all()), int(nerr[0])
    rows = _deinterleave(coded[: coded_len(m)], sizes)
    S = _syndromes(rows)
    dirty = S.any(axis=1)
    ok = np.ones(len(sizes), dtype=bool)
    nerr = np.zeros(len(sizes), dtype=np.int64)
    if dirty.any():
        Lam = _berlekamp_massey(S[dirty])
        sub = rows[dirty]  # fancy indexing copies: correct, then write back
        received = sub.copy()  # pristine snapshot: failed rows must revert
        okd, nd = _chien_forney(sub, S[dirty], Lam)
        # re-verify: corrected rows must have zero syndromes
        okd &= ~_syndromes(sub).any(axis=1)
        # Honor the UNCORRECTED contract: a failed Chien-Forney pass leaves
        # spurious XORs in `sub`; restore those rows to the received word.
        sub[~okd] = received[~okd]
        rows[dirty] = sub
        ok[dirty] = okd
        nerr[dirty] = nd
        # a "correction" landing in a shortened row's virtual pad is a
        # miscorrection: the pad is zero by construction
        lens = np.asarray([s + NROOTS for s in sizes])
        pads = rows.shape[1] - lens
        for i in np.nonzero(pads > 0)[0]:
            if rows[i, : pads[i]].any():
                ok[i] = False
        rows_all = rows
    else:
        rows_all = rows
    nmax = rows_all.shape[1]
    out = [rows_all[i, nmax - (s + NROOTS): nmax - NROOTS]
           for i, s in enumerate(sizes)]
    return (np.concatenate(out).tobytes(), bool(ok.all()),
            int(nerr[ok].sum()))


# --- errors-and-erasures (soft-decision fallback path) ----------------------


def _ee_decode_block(row: list[int], era_pos: list[int]) -> bool:
    """Errors-and-erasures decode of one full-length-aligned row in place.
    `era_pos` are column indices flagged as erasures (low confidence).
    Plain-Python scalar path — runs only for blocks the hard pass failed.
    Returns True when the errata locator is consistent (decode trusted)."""
    n = len(row)
    nera = len(era_pos)
    if nera > NROOTS:
        era_pos = era_pos[:NROOTS]
        nera = NROOTS

    def mul(a, b):
        if a == 0 or b == 0:
            return 0
        return int(_EXP[_LOG[a] + _LOG[b]])

    def poly_eval_log(poly, xlog):
        acc = 0
        for j, c in enumerate(poly):
            if c:
                acc ^= int(_EXP[(_LOG[c] + xlog * j) % 255])
        return acc

    S = [0] * NROOTS
    for j in range(1, NROOTS + 1):
        acc = 0
        for i, c in enumerate(row):
            if c:
                acc ^= int(_EXP[(_LOG[c] + ((n - 1 - i) * j)) % 255])
        S[j - 1] = acc
    if not any(S):
        return True
    # erasure locator Gamma(x) = prod (1 - X_l x), X_l = alpha^{n-1-pos}
    Gam = [1]
    for p in era_pos:
        xl = int(_EXP[(n - 1 - p) % 255])
        Gam = [Gam[k] ^ (mul(Gam[k - 1], xl) if k else 0)
               for k in range(len(Gam))] + [mul(Gam[-1], xl)]
    # BM over the ORIGINAL syndromes with the locator initialized to the
    # erasure polynomial: both Lambda and B stay divisible by Gamma, so the
    # erasure positions remain roots of the final errata locator.
    C = Gam + [0] * (NROOTS + 1 - len(Gam))
    B = list(C)
    L, mshift, b = nera, 1, 1
    for n_ in range(nera, NROOTS):
        d = 0
        for j in range(min(n_, len(C) - 1) + 1):
            if C[j]:
                d ^= mul(C[j], S[n_ - j])
        if d == 0:
            mshift += 1
            continue
        coef = mul(d, int(gf_inv(np.uint8(b))))
        Cn = list(C)
        for j in range(len(B)):
            if B[j] and j + mshift < len(Cn):
                Cn[j + mshift] ^= mul(coef, B[j])
        if 2 * L <= n_ + nera:
            B, b, L, mshift, C = C, d, n_ + 1 - L + nera, 1, Cn
        else:
            C = Cn
            mshift += 1
    # Chien over the errata locator
    deg = max((j for j, c in enumerate(C) if c), default=0)
    pos, xinv_logs = [], []
    for i in range(n):
        xlog = (255 - (n - 1 - i) % 255) % 255
        if poly_eval_log(C, xlog) == 0:
            pos.append(i)
            xinv_logs.append(xlog)
    if len(pos) != deg or deg > NROOTS:
        return False
    # errata evaluator Omega = S(x) * C(x) mod x^NROOTS
    Om = [0] * NROOTS
    for a in range(min(len(C), NROOTS)):
        if not C[a]:
            continue
        for b_ in range(NROOTS - a):
            Om[a + b_] ^= mul(C[a], S[b_])
    for i, xlog in zip(pos, xinv_logs):
        lamd = 0
        for j in range(1, len(C), 2):
            if C[j]:
                lamd ^= int(_EXP[(_LOG[C[j]] + xlog * (j - 1)) % 255])
        if lamd == 0:
            return False
        om = poly_eval_log(Om, xlog)
        row[i] ^= mul(om, int(gf_inv(np.uint8(lamd))))
    # verify
    for j in range(1, NROOTS + 1):
        acc = 0
        for i, c in enumerate(row):
            if c:
                acc ^= int(_EXP[(_LOG[c] + ((n - 1 - i) * j)) % 255])
        if acc:
            return False
    return True


def rs_decode_interleaved_soft(coded, m: int, confidence):
    """Errors-and-erasures decode: like rs_decode_interleaved but blocks the
    hard pass cannot correct retry with their NROOTS lowest-`confidence`
    bytes marked as erasures (2e + f <= NROOTS). `confidence` is one float
    per coded byte, interleaved order — the pipeline supplies the minimum
    |decision value| of the byte's 8 bits (ops/phase.py read_values)."""
    sizes = _block_sizes(m)
    coded = np.frombuffer(bytes(coded), dtype=np.uint8) if isinstance(
        coded, (bytes, bytearray)) else np.asarray(coded, dtype=np.uint8)
    conf = np.asarray(confidence, dtype=np.float64)
    lib = _native()
    if lib is not None:
        msg, ok, _ = lib.rs_decode(
            coded[: coded_len(m)], m,
            conf[: coded_len(m)].astype(np.float32))
        return msg.tobytes(), bool(ok.all())
    rows = _deinterleave(coded[: coded_len(m)], sizes)
    # confidence rows aligned with the byte rows (pad = +inf: never erased)
    nb = len(sizes)
    nmax = rows.shape[1]
    crow = np.full((nb, nmax), np.inf)
    lens = [s + NROOTS for s in sizes]
    perm = _interleave_perm(sizes)
    cflat = np.empty(int(np.sum(lens)))
    cflat[perm] = conf[: len(perm)]
    off = 0
    for i in range(nb):
        crow[i, nmax - lens[i]:] = cflat[off: off + lens[i]]
        off += lens[i]
    S = _syndromes(rows)
    dirty = np.nonzero(S.any(axis=1))[0]
    ok = np.ones(nb, dtype=bool)
    if len(dirty):
        Lam = _berlekamp_massey(S[dirty])
        sub = rows[dirty]
        received = sub.copy()
        okd, _ = _chien_forney(sub, S[dirty], Lam)
        okd &= ~_syndromes(sub).any(axis=1)
        # Failed rows revert to the pristine received word so the erasure
        # ladder below starts from the channel output, not a word garbled by
        # the failed hard pass's spurious corrections (which land at high-
        # confidence, never-erased positions and sink recoverable blocks).
        sub[~okd] = received[~okd]
        rows[dirty] = sub
        ok[dirty] = okd
        for bi in np.nonzero(~ok)[0]:
            # Erasure count ladder, capped BELOW NROOTS: erasing all 32
            # leaves zero parity margin, and then ANY received word extends
            # to a valid codeword (shortened code: known positions = k) —
            # always-"success", usually miscorrected. Each rung f leaves
            # NROOTS - f syndrome checks as its consistency margin and
            # tolerates (NROOTS - f) / 2 unflagged errors.
            order = [int(e) for e in np.argsort(crow[bi], kind="stable")
                     if np.isfinite(crow[bi][e])]
            base = [int(v) for v in rows[bi]]
            pad = rows.shape[1] - (sizes[bi] + NROOTS)
            for f in (NROOTS - 8, NROOTS // 2, 8):
                row = list(base)
                if (_ee_decode_block(row, order[:f])
                        and not any(row[:pad])):
                    rows[bi] = row
                    ok[bi] = True
                    break
    out = [rows[i, nmax - (s + NROOTS): nmax - NROOTS]
           for i, s in enumerate(sizes)]
    return np.concatenate(out).tobytes(), bool(ok.all())
