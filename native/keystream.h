// Keyed turtle-walk keystream expansion — the reference's only strictly
// sequential component (steganosaur.cpp:665-810), run on the host so the
// device side is one vectorized gather/scatter. Semantics are byte-exact with
// the reference; see steganosaurus_jax/keystream/_pure.py for the annotated
// Python twin used as the test oracle.
#pragma once

#include <cstdint>

namespace stego {

// Expands `nbits` accepted bins. Writes plane/y/x (int32) and jitter (double)
// per bit. Returns the number of bits produced (== nbits on full success).
// If `max_steps` is exhausted first (bounds the reference's corrupted-clen
// hang, doc/TESTING.md:151-156): with allow_short != 0 the remaining output
// slots are padded with the last produced bin (jitter 0) and the true count
// is returned; with allow_short == 0 returns -1.
int64_t turtle_expand(const uint8_t walk_key[32], const uint8_t key_r[32],
                      const uint8_t key_g[32], const uint8_t key_b[32], int H,
                      int W, double rmin, double rmax, double density,
                      double jitter_max, int64_t nbits, int64_t max_steps,
                      int allow_short, int32_t* out_plane, int32_t* out_y,
                      int32_t* out_x, double* out_jitter);

// As turtle_expand, plus visited-bitmap chaining for the per-image-walk
// mode (steganosaurus_jax/pipeline — salt-keyed payload walks resume from
// the shared header walk's visited state so per-image bins never collide
// with the header's). Bitmaps are (3*H*W + 63)/64 uint64 words, bit index
// (plane*H + y)*W + x. init_visited (nullable) pre-seeds the visited set;
// out_visited (nullable) receives the final visited state (also on
// allow_short padding).
int64_t turtle_expand_v(const uint8_t walk_key[32], const uint8_t key_r[32],
                        const uint8_t key_g[32], const uint8_t key_b[32],
                        int H, int W, double rmin, double rmax, double density,
                        double jitter_max, int64_t nbits, int64_t max_steps,
                        int allow_short, int32_t* out_plane, int32_t* out_y,
                        int32_t* out_x, double* out_jitter,
                        const uint64_t* init_visited, uint64_t* out_visited);

// As turtle_expand_v, plus the coherent site semantics (Params.coherent
// payload walks; pure twin keystream/_pure.py coherent=True): with
// coherent != 0 the visited check rejects a candidate if ANY plane of its
// (y, x) site or the conjugate site is marked, and every mark — accept and
// density-skip alike — marks all three planes at both sites. Keystream
// consumption is unchanged, so embed/extract replay exactly.
int64_t turtle_expand_vc(const uint8_t walk_key[32], const uint8_t key_r[32],
                         const uint8_t key_g[32], const uint8_t key_b[32],
                         int H, int W, double rmin, double rmax,
                         double density, double jitter_max, int64_t nbits,
                         int64_t max_steps, int allow_short, int coherent,
                         int32_t* out_plane, int32_t* out_y, int32_t* out_x,
                         double* out_jitter, const uint64_t* init_visited,
                         uint64_t* out_visited);

}  // namespace stego
