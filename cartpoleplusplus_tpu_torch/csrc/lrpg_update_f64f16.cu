// The F64 and F16 instances of lrpg_update.cu's passes (learner_stages.cuh's
// product modes), compiled in a translation unit of their own so that
// they build beside the others; the launcher in lrpg_update.cu takes
// them from cp_lrpg_f64f16_phase.
#define CP_MM_PRESET_UNIT 2
#include "lrpg_update.cu"
