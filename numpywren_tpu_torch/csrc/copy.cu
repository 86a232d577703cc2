// Tile lists between host and device for the out-of-core Cholesky
// (runtime/spill.py): one cudaMemcpy2DAsync a tile, all enqueued on one
// stream by one call, so a strip of many pinned host tiles lands in its
// strided slices of a device panel by the copy engines, with no temporary
// and no copy kernel. No kernel runs here.
#include <cuda_runtime.h>
#include <stddef.h>

extern "C" {

// Copy `count` tiles of `rows` rows of `width` bytes each: tile k from
// srcs[k] (rows `spitch` bytes apart) to dsts[k] (rows `dpitch` apart), in
// direction `kind` (a cudaMemcpyKind), on `stream`. Returns the first CUDA
// error, else 0.
int npw_copy_tiles(int count, void* const* dsts, size_t dpitch, const void* const* srcs,
                   size_t spitch, size_t width, size_t rows, int kind, cudaStream_t stream) {
  for (int k = 0; k < count; ++k) {
    cudaError_t err = cudaMemcpy2DAsync(dsts[k], dpitch, srcs[k], spitch, width, rows,
                                        static_cast<cudaMemcpyKind>(kind), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
