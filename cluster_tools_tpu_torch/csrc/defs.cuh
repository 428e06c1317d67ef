// Constants shared by every kernel source: the flood's "unreached" altitude
// and hop count, and the CC's "no label" sentinel.
#pragma once

#define CTT_BIG 3.0e38f
#define CTT_BIG_DIST 2147483646
#define CTT_SENT 2147483646  // "no root" of kernel 2's maxima CC; background of kernel 4
