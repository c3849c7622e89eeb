// The output planes of the CWT kernels' second launches, shared by kernels
// D and E (cwt_planes.cu, on cwt_pair.cuh) and the probes P1-P3
// (ablate_cwt.cu):
// pipeline p's kept outputs plus its Nyquist term go to planes (o[2p],
// o[2p+1]); nyq[2p], nyq[2p+1] are its (rows,) Nyquist real and imaginary
// values.
#pragma once

struct Planes {
  const float* nyq[4];
  float* o[4];
};
