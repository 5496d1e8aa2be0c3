// K4 forward: see linf_flow_nd.cuh.

#include "linf_flow_nd.cuh"

// w: (L+1, d, d) torch layout (y = W x + b); b: (L+1, d); x, out: (n, d);
// info: (2dL, n) channel-major.  d must be 12, 27 or 48.
extern "C" int linf_flow_nd_forward(const void* w, const void* b,
                                    const void* x, const void* info,
                                    void* out, int n, int n_layers, int d,
                                    void* stream) {
  return bfsr_k4::launch<false>(w, b, x, info, out, n, n_layers, d, stream);
}
