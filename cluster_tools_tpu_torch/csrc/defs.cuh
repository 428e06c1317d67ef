// Constants shared by every kernel source: the flood's "unreached" altitude
// and hop count, the CC's "no label" sentinel and the pointer jump's reads
// in flight.
#pragma once

#define CTT_BIG 3.0e38f
#define CTT_BIG_DIST 2147483646
#define CTT_SENT 2147483646  // "no root" of kernel 2's maxima CC; background of kernels 4-5
#define CTT_CC_JUMPS 4        // pointer-jump targets a lane of kernels 4-5 reads at once
