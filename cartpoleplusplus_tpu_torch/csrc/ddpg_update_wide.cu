// The float32 instance of ddpg_update.cu's kernel with the wide row items
// (row_chain.cuh's kRowsW), compiled in a translation unit of its own so
// that it builds beside the others; the launcher in ddpg_update.cu takes it
// from cp_ddpg_wide_kernel.
#define CP_MM_PRESET_UNIT 3
#include "ddpg_update.cu"
