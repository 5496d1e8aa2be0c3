// K4 inverse: see linf_flow_nd.cuh.

#include "linf_flow_nd.cuh"

// w_inv: (L+1, d, d) cached inverses; b: (L+1, d); z, out: (n, d);
// info: (2dL, n) channel-major.  d must be 12, 27 or 48.
extern "C" int linf_flow_nd_inverse(const void* w_inv, const void* b,
                                    const void* z, const void* info,
                                    void* out, int n, int n_layers, int d,
                                    void* stream) {
  return bfsr_k4::launch<true>(w_inv, b, z, info, out, n, n_layers, d, stream);
}
