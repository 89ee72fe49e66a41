// K3's bf16 kernels (flash_attention_pipelined.cu), compiled apart from
// the rest of the library so that its dtypes build in parallel.
#include "flash_tile.cuh"

FLASH_RING_INSTANCE(template, __nv_bfloat16);
