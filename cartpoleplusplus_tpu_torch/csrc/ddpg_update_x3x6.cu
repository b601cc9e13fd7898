// The X3 and X6 instances of ddpg_update.cu's kernel (learner_stages.cuh's
// product modes), compiled in a translation unit of their own so that
// they build beside the others; the launcher in ddpg_update.cu takes them
// from cp_ddpg_x3x6_kernel.
#define CP_MM_PRESET_UNIT 1
#include "ddpg_update.cu"
