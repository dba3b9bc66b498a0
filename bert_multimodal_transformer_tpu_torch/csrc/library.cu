// The library-wide entries of the port's kernel library (every csrc/*.cu
// links into one shared object, ops/kernels.py: attn_{fwd,bwd}_packed*
// (the full-H, _hb and _fs tiers), attn_{fwd,bwd}_rel* (the full-H, _hb
// and _fs tiers), attn_{fwd,bwd}_relik_fs, mag_{fwd,bwd}).

#include <cuda_runtime.h>

extern "C" {

// The message of a cudaError_t that an entry returned.
const char* torch_kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
