// The X3 and X6 instances of dqn_update.cu's kernel (learner_stages.cuh's
// product modes), compiled in a translation unit of their own so that
// they build beside the others; the launcher in dqn_update.cu takes them
// from cp_dqn_x3x6_kernel.
#define CP_MM_PRESET_UNIT 1
#include "dqn_update.cu"
