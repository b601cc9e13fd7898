// The float32 instance of naf_update.cu's kernel with the wide row items
// (row_chain.cuh's kRowsW), compiled in a translation unit of its own so
// that it builds beside the others; the launcher in naf_update.cu takes it
// from cp_naf_wide_kernel.
#define CP_MM_PRESET_UNIT 3
#include "naf_update.cu"
