// C API for ctypes bindings (steganosaurus_jax/_native_loader.py).
#include <cstdint>

#include "aead.h"
#include "keystream.h"

extern "C" {

int stego_aead_seal(const uint8_t* key, const uint8_t* nonce,
                    const uint8_t* aad, size_t aadlen, const uint8_t* pt,
                    size_t len, uint8_t* ct_out, uint8_t* tag_out,
                    int ref_compat) {
  return stego::aead_seal(key, nonce, aad, aadlen, pt, len, ct_out, tag_out,
                          ref_compat != 0);
}

int stego_aead_open(const uint8_t* key, const uint8_t* nonce,
                    const uint8_t* aad, size_t aadlen, const uint8_t* ct,
                    size_t len, const uint8_t* tag, uint8_t* pt_out,
                    int ref_compat) {
  return stego::aead_open(key, nonce, aad, aadlen, ct, len, tag, pt_out,
                          ref_compat != 0);
}

long long stego_turtle_expand(const uint8_t* walk_key, const uint8_t* key_r,
                              const uint8_t* key_g, const uint8_t* key_b,
                              int H, int W, double rmin, double rmax,
                              double density, double jitter_max,
                              long long nbits, long long max_steps,
                              int allow_short, int32_t* out_plane,
                              int32_t* out_y, int32_t* out_x,
                              double* out_jitter) {
  return stego::turtle_expand(walk_key, key_r, key_g, key_b, H, W, rmin, rmax,
                              density, jitter_max, nbits, max_steps,
                              allow_short, out_plane, out_y, out_x, out_jitter);
}

// v-variant: visited-bitmap chaining for salt-keyed per-image payload walks
// (init/out nullable; bitmap layout documented in native/keystream.h).
long long stego_turtle_expand_v(const uint8_t* walk_key, const uint8_t* key_r,
                                const uint8_t* key_g, const uint8_t* key_b,
                                int H, int W, double rmin, double rmax,
                                double density, double jitter_max,
                                long long nbits, long long max_steps,
                                int allow_short, int32_t* out_plane,
                                int32_t* out_y, int32_t* out_x,
                                double* out_jitter,
                                const uint64_t* init_visited,
                                uint64_t* out_visited) {
  return stego::turtle_expand_v(walk_key, key_r, key_g, key_b, H, W, rmin,
                                rmax, density, jitter_max, nbits, max_steps,
                                allow_short, out_plane, out_y, out_x,
                                out_jitter, init_visited, out_visited);
}

// vc-variant: v + coherent site semantics (Params.coherent payload walks —
// any-plane visited checks, all-plane marks; native/keystream.h).
long long stego_turtle_expand_vc(const uint8_t* walk_key, const uint8_t* key_r,
                                 const uint8_t* key_g, const uint8_t* key_b,
                                 int H, int W, double rmin, double rmax,
                                 double density, double jitter_max,
                                 long long nbits, long long max_steps,
                                 int allow_short, int coherent,
                                 int32_t* out_plane, int32_t* out_y,
                                 int32_t* out_x, double* out_jitter,
                                 const uint64_t* init_visited,
                                 uint64_t* out_visited) {
  return stego::turtle_expand_vc(walk_key, key_r, key_g, key_b, H, W, rmin,
                                 rmax, density, jitter_max, nbits, max_steps,
                                 allow_short, coherent, out_plane, out_y,
                                 out_x, out_jitter, init_visited, out_visited);
}

}  // extern "C"
