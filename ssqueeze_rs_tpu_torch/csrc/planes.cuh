// The output planes of the CWT kernels' second launches, shared by kernels
// D and E (cwt_planes.cu) and the probes' radix-2 design (cwt_planes.cuh):
// pipeline p's kept outputs plus its Nyquist term go to planes (o[2p],
// o[2p+1]); nyq[2p], nyq[2p+1] are its (rows,) Nyquist real and imaginary
// values.
#pragma once

struct Planes {
  const float* nyq[4];
  float* o[4];
};
