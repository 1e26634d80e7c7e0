// outer_update.cu with the cluster route's phase stamps compiled in
// (chip_smoke.py reads them to break a segment's time into phases).
#define DGLKE_OUTER_STAMPS
#include "outer_update.cu"
