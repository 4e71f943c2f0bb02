// attention_bwd_rows[dropout,qknorm]: one instantiation per key-chunk count
// (attention_bwd_rows.cuh), in a source of its own so that nvcc builds the
// four variants in parallel.

#include "attention_bwd_rows.cuh"

cudaError_t attention_bwd_launch_dropout_qknorm(int kt, const AttnBwdArgs& args, const AttnBwdMaps& maps, unsigned blocks,
                                                cudaStream_t stream) {
  return launch_attention_bwd<true, true>(kt, args, maps, blocks, stream);
}
