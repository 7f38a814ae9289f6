// The shared step table of the jitter window structure: one row of 24
// words per query step (ops/mxu_jitter.py JitterWindowMatrices.steps,
// STEP_WORDS), read by the jitter and masked rungs (jitter_range.cu) and the
// histogram range kernel's jitter mode (hist_range.cu).

#pragma once

namespace jitter_steps {

struct StepRow {
    int clo, chi;                      // certain range [clo, chi)
    int iF0, iL0, iL2, iKlo, iKhi;     // selection indices, clipped to the row
    int flags;                         // 1 c0pos, 2 c0ge2, 4 has_klo, 8 has_khi
    float count0;                      // certain count
    float F0_rel, L0_rel, L2_rel, Klo_rel, Khi_rel;  // nominal times - window start
    float blo_rel, ehi_rel;            // membership bounds of klo, khi
    int nF0, nL0, nL2, nKlo, nKhi;     // nominal offsets at the indices (JITTER)
    int pad[3];
};
static_assert(sizeof(StepRow) == 96, "StepRow is 24 words");

// StepRow.flags
constexpr int C0POS = 1, C0GE2 = 2, HAS_KLO = 4, HAS_KHI = 8;

}  // namespace jitter_steps
