// The F64 and F16 instances of naf_update.cu's kernel (learner_stages.cuh's
// product modes), compiled in a translation unit of their own so that
// they build beside the others; the launcher in naf_update.cu takes them
// from cp_naf_f64f16_kernel.
#define CP_MM_PRESET_UNIT 2
#include "naf_update.cu"
