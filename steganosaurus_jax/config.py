"""Embedding parameter surface.

Mirrors the reference `Params` struct (steganosaur.cpp:375-381) with the same
defaults. Note the reference's `usage()` text claims adaptive_alpha /
cover_dependent_path default to 1; the code (and README.md:101-102) says 0 —
we follow the code.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Params:
    """Embedding/extraction parameters (reference steganosaur.cpp:375-381)."""

    alpha: float = 0.50          # base phase shift magnitude (radians)
    rmin: float = 0.05           # annulus inner radius as fraction of min(H, W)
    rmax: float = 0.45           # annulus outer radius as fraction of min(H, W)
    magmin: float = 0.01         # magnitude threshold factor (capacity only;
                                 # the walk's mag check is disabled, :797-799)
    density: float = 0.7         # Bernoulli embed probability per candidate bin
    jitter: float = 0.0          # max keyed phase jitter (radians)
    center: bool = False         # (-1)^(x+y) spectrum centering pre/post FFT
    pbkdf2_iter: int = 600_000   # PBKDF2-HMAC-SHA256 iterations
    adaptive_alpha: bool = False       # experimental: magnitude-scaled alpha
    cover_dependent_path: bool = False  # experimental: spectral-hash-keyed walk

    # --- rebuild-only knobs (no reference equivalent) ---
    # FFT compute dtype: "complex64" (device default) or "complex128" (CPU
    # parity arbiter).
    fft_dtype: str = "complex64"
    # Minimal-energy phase write: leave bins that already decode with
    # margin >= alpha untouched, clamp the rest to the margin boundary.
    # ~2.8x less write energy (+3-5 dB stego PSNR at equal payload); the
    # decode rule is unchanged and the reference binary still extracts the
    # output (its read is the same half-plane test). Default off: stego
    # pixels diverge from the reference's write. See ops/phase.py,
    # doc/ATTACKS.md §1a.
    soft_write: bool = False
    # Soft-decision recovery fallback (extraction-side only, wire-format
    # unchanged): when a batch image's AEAD fails under the reference's
    # hard majority vote, re-decode it once with matched-filter combining —
    # each Rep-3/Rep-7 copy weighted by its decision value mag*sin(theta -
    # jitter), so weak quantization-flipped copies cannot outvote a strong
    # correct one (ops/ecc.py rep_decode_soft). Strictly additive: runs
    # only on already-failed images, recovers stegos the reference binary
    # itself cannot extract (its own embeds included), never changes a
    # passing result. Default on.
    soft_decode_fallback: bool = True
    # Quantization write floor (embed-side only, wire-format unchanged):
    # minimum spatial RMS (in pixel LSBs, over all 3xHxW plane-pixels) the
    # written delta must reach to survive u8 rounding. The cover is
    # integer-valued, so a write whose per-pixel delta stays under 0.5 LSB
    # is ERASED DETERMINISTICALLY by round() — measured at 4K with a
    # single-bucket frame: delta RMS 0.15, read-back BER 0.45, i.e. total
    # loss (the reference shares this physics; it simply can never reach
    # the regime because it cannot round-trip non-pow2 >= 1080p at all).
    # When the predicted RMS is below the floor, every moved bin's write
    # target is magnitude-boosted nv -> b*nv (phase EXACT, so decoding —
    # including by the reference binary — is unchanged; b solved in closed
    # form from the Parseval energy, clipped to [1, 32]). b == 1 whenever
    # the write is already above the floor, leaving all certified configs
    # bit-identical. Trade-off: boosted bins are a magnitude spike a
    # warden can see — doc/ATTACKS.md; 0 disables (restores the erasure).
    # Default-on CONFIRMED deliberate (round-5 review of the round-4
    # advisor's flag): b == 1 above the floor, so the only embeds whose
    # bytes change are ones that previously produced an undecodable stego
    # (read-back BER ~0.45) — "embed yields a decodable stego" outranks
    # marginal-regime stealth as the default; stealth-first configs set 0.
    write_floor: float = 0.45
    # Salt-keyed per-image payload walks: the 38-byte header embeds on the
    # shared salt-independent walk prefix (it must stay locatable before the
    # salt is known), then the
    # payload walk re-keys from SHA256(path_key || salt) and resumes from the
    # header walk's visited state. Defeats the shared-walk correlation
    # attack for bulk collections under one key (doc/ATTACKS.md §4): payload
    # bin sets become independent per image (overlap falls from 100% to the
    # random-coincidence rate), so residual averaging at common bins gains
    # nothing past the 912 header bins. Wire-format: header FLAGS bit 0x01
    # (pipeline/header.py) — extraction auto-detects it, no param needed;
    # the reference binary fails closed (AEAD) on flagged stegos. Costs a
    # per-image sequential host walk (threaded across the batch) and
    # per-image device index arrays. Default off for reference parity.
    per_image_walk: bool = False
    # Keyed per-bin randomized write amplitude: bin i is written at
    # alpha_i = alpha * (1 + alpha_spread * v_i) with v_i in [0, 1) drawn
    # from an independent keystream keyed by the path key — one-sided so
    # every bin's decode margin stays >= the hard write's alpha
    # (pipeline/spread.py explains the measured failure that rules out
    # a symmetric spread). Kills the phase-residual histogram spikes at
    # +-alpha (the reference's own doc/TODO.md "per-bin randomized alpha"
    # item) at zero extraction cost: the decode rule is a half-plane test
    # that never uses the written amplitude, so extraction — INCLUDING by
    # the stock reference binary — is unchanged and needs no knowledge of
    # the spread. Requires alpha*(1+alpha_spread) < pi. Default off for
    # pixel-level reference parity. See doc/ATTACKS.md §2a.
    alpha_spread: float = 0.0
    # Dithered phase QIM for the PAYLOAD bits (rebuild-only; the reference's
    # own doc/TODO.md lists "quantization index modulation (QIM/STDM)" as
    # future work). qim = L >= 2 quantizes each payload bin's phase to a
    # keyed-dithered lattice of step 2*pi/L: bit-0 centroids at d_i + k*Delta,
    # bit-1 at d_i + (k+1/2)*Delta, with d_i uniform in [0, Delta) drawn from
    # an independent keystream keyed by the path key (pipeline/qim.py). The
    # header stays on the reference's hard +-alpha write (it must be
    # locatable and decodable before any mode is known); header FLAGS bits
    # 4-7 carry L so extraction auto-detects it — no param needed. Decode
    # margin is Delta/4 = pi/(2L) (L=3 ~ the hard write's alpha=0.5);
    # write energy is E[dtheta^2] = Delta^2/12 — ~9x below the hard write
    # and ~3x below soft_write at L=3, and shrinks as L grows (the
    # payload/PSNR frontier lever, doc/ATTACKS.md §1b). Stealth: the keyed
    # dither makes written-bin phases marginally UNIFORM — no +-alpha spike,
    # no soft-write notch (§2b). The stock reference binary fails closed on
    # QIM stegos (payload decodes garbage -> AEAD failure). 0 = off
    # (reference parity). Valid range 2..15 (4-bit header field).
    qim: int = 0
    # Interleaved Reed-Solomon payload FEC (rebuild-only; the reference's
    # own doc/TODO.md lists "Stronger FEC (Reed-Solomon or LDPC)" with
    # "interleaving across turtle sequence" as future work). rs=True codes
    # the payload as systematic RS(255,223) over GF(2^8) — 32 parity bytes
    # / t=16 correctable byte errors per codeword, column-major interleaved
    # across codewords so bin bursts spread out (ops/rs.py). Expansion
    # 255/223 ~ 1.14x vs Rep-7's 7x: ~6.1x more payload per written bin,
    # ~6x less walk time and write energy at equal payload. The trade: RS
    # tolerates ~6% byte corruption vs Rep-7's 43% bit BER — ample for the
    # hard/soft/low-L QIM channels (certified raw BER ~0.16%), wrong for
    # deep QIM (L >= 12 measured ~3.5% bit flips => ~25% byte errors).
    # Header stays Rep-3 on the hard write; header FLAGS bit 0x02 makes
    # extraction self-describing (no param needed). The stock reference
    # binary fails closed on RS stegos (payload walk length diverges ->
    # AEAD failure). Default off for reference parity.
    rs: bool = False
    # Payload padding quantum in bytes (rebuild-only; the reference's own
    # doc/TODO.md lists "Payload Padding — add random padding to
    # ciphertext to obscure message length" as future work). pad_quantum=q
    # > 0 frames the plaintext as BE32(true_len) || secret || keyed pad up
    # to the next q multiple before sealing, so the header clen — and the
    # written-bin footprint a warden could count — quantizes to q-byte
    # buckets instead of leaking the exact message length
    # (pipeline/header.py pad_plaintext). Header FLAGS bit 0x04 makes
    # extraction self-describing; the stock reference binary still
    # AEAD-opens padded stegos (rc 0) but its output truncates at the
    # length prefix's leading NUL bytes, so the secret never reaches its
    # stdout (measured; interop degraded, not crashed). Costs capacity:
    # the padded clen is what embeds. Default off for reference parity.
    pad_quantum: int = 0

    # Channel-coherent payload write (rebuild-only; the measured answer to
    # the cross-channel warden, doc/ATTACKS.md §2e). The standard walk
    # writes ONE plane's bin per bit, leaving a "two aligned, one off"
    # R/G/B phase triple that is AUC-1.0 detectable on photographic
    # (correlated-channel) covers under EVERY other mitigation. coherent=
    # True instead rotates ALL THREE planes at each payload site by one
    # common delta, encoding the bit in the common-mode phase (angle of
    # the per-plane unit-phasor sum, ops/phase.py _coherent_common):
    # every pairwise phase difference is preserved EXACTLY, so the
    # warden's alignment statistics see the cover's own values at written
    # sites. Costs: ~3x write energy per bit (three planes move) and ~3x
    # payload walk footprint (a site is consumed whole — keystream
    # coherent semantics), i.e. a louder spatial-residual (§2d) footprint
    # at equal payload — measured trade in doc/ATTACKS.md §2e. The header
    # stays on the standard shared-walk write (it must decode before any
    # mode is known); the payload rides a salt-keyed chained walk (the
    # per_image_walk structure) with coherent site semantics. Header
    # FLAGS bit 0x08 makes extraction self-describing; the stock
    # reference binary fails closed. Composes with qim/soft_write/jitter/
    # alpha_spread/rs/pad_quantum; mutually exclusive with adaptive_alpha
    # (a per-plane magnitude rescale of alpha has no common-mode analog).
    # Default off for reference parity.
    coherent: bool = False

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)

    @classmethod
    def stealth(cls, **kw) -> "Params":
        """The recommended stealth-sensitive profile (doc/ATTACKS.md):
        dithered phase QIM for the payload at L=3 (uniform written-bin
        phases at the hard write's decode margin, §2b), keyed phase
        jitter (the reference's own mitigation, ~pi/8) + one-sided
        amplitude spread + minimal-energy soft write for the 912
        hard-written HEADER bins (§2a/§1a), and per-image payload walks
        (defeats cross-image averaging, §4).

        Measured warden view at a heavy 256^2 footprint (f ~ 0.43,
        utils/steganalysis.py): chi^2 z-score 3602 (defaults) -> 418
        (the 0.4 jitter+spread profile) -> 1.3 with QIM — EQUAL to the
        clean cover's 1.3, i.e. statistically indistinguishable from
        unmodified at a footprint every other mode fails; spike excess
        0.209 -> -0.0005; PSNR +6.7 dB on top. Extraction needs the SAME
        jitter value (as in the reference); everything else is
        auto-detected or embed-side-only. The stock reference binary
        cannot extract these images (per_image_walk and qim both fail it
        closed) — use stealth(per_image_walk=False, qim=0) if reference
        interop matters more than warden resistance. Keyword overrides
        win."""
        base = dict(jitter=0.39, alpha_spread=1.0, soft_write=True,
                    per_image_walk=True, qim=3)
        base.update(kw)
        return cls(**base)


DEFAULTS = Params()
