// The float32 instance of dqn_update.cu's kernel with the wide row items
// (row_chain.cuh's kRowsW), compiled in a translation unit of its own so
// that it builds beside the others; the launcher in dqn_update.cu takes it
// from cp_dqn_wide_kernel.
#define CP_MM_PRESET_UNIT 3
#include "dqn_update.cu"
