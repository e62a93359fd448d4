// Position layout of the format-v4 rANS encode, shared by K3
// (rans_encode.cu) and K6 (rans_compact.cu).
//
// The prep leaves its outputs in the caller's [B, n] layout: the z section
// [B, n_z] and the y section [B, n_phases * n_per] (phase k holds columns
// [k * n_per, (k + 1) * n_per)).  The coder walks positions (step, image,
// lane), step-major, image-major, lane-minor: first ceil(n_z / n_lanes)
// steps of z, then ceil(n_per / n_lanes) steps of each y phase; step js of
// a section covers its entries [js * n_lanes, (js + 1) * n_lanes), and the
// tail of a section's last step is pad.  The kernels compute a position's
// source from these numbers instead of reading a laid-out copy: K6 by
// encode_run below, a mask word's 32 positions at once, K3 by the same
// arithmetic walked step by step (``device_rans.encode_sources_plain`` is
// it in PyTorch).
#pragma once

#include <stdint.h>

struct EncodeLayout {
  int n_images, n_lanes, lane_shift;   // n_lanes = 1 << lane_shift
  int n_z, n_per, n_phases, n_y;       // n_y = n_phases * n_per
  int steps_z, steps_per, steps;       // steps = steps_z + n_phases * steps_per
  int lanes;                           // n_images * n_lanes
  int words_per_step;                  // 32-lane mask words of one image's step
};

// Fills ``lay``; false for a geometry the kernels do not take: lanes not a
// power of two in [1, 1024], no image, negative sizes, or positions and
// word buffers beyond int32 indexing.
inline bool make_encode_layout(EncodeLayout* lay, int n_images, int n_lanes,
                               int n_z, int n_per, int n_phases) {
  if (n_lanes < 1 || n_lanes > 1024 || (n_lanes & (n_lanes - 1)) ||
      n_images < 1 || n_z < 0 || n_per < 0 || n_phases < 0)
    return false;
  int shift = 0;
  while ((1 << shift) < n_lanes) ++shift;
  const long long steps_z = (n_z + n_lanes - 1) / n_lanes;
  const long long steps_per = (n_per + n_lanes - 1) / n_lanes;
  const long long steps =
      steps_z + static_cast<long long>(n_phases) * steps_per;
  const long long lanes = static_cast<long long>(n_images) * n_lanes;
  const long long n_y = static_cast<long long>(n_phases) * n_per;
  if (steps * lanes + 2 * lanes >= (1ll << 31) ||
      static_cast<long long>(n_images) * (n_y + n_z) >= (1ll << 31))
    return false;
  lay->n_images = n_images;
  lay->n_lanes = n_lanes;
  lay->lane_shift = shift;
  lay->n_z = n_z;
  lay->n_per = n_per;
  lay->n_phases = n_phases;
  lay->n_y = static_cast<int>(n_y);
  lay->steps_z = static_cast<int>(steps_z);
  lay->steps_per = static_cast<int>(steps_per);
  lay->steps = static_cast<int>(steps);
  lay->lanes = static_cast<int>(lanes);
  lay->words_per_step = n_lanes < 32 ? 1 : n_lanes / 32;
  return true;
}

// The run of positions (step s, image b, lanes l0 .. l0 + 31) that one
// 32-lane mask word covers: returns the flat source index of lane l0 in
// the z section (``*in_y`` false) or the y section (``*in_y`` true) and
// sets ``*valid`` to the number of the run's lanes that are no pad, whose
// sources follow one another (l0 is a multiple of 32).
__device__ __forceinline__ int encode_run(const EncodeLayout& lay, int s,
                                          int b, int l0, bool* in_y,
                                          int* valid) {
  int base, j, n;
  if (s < lay.steps_z) {
    *in_y = false;
    base = b * lay.n_z;
    j = (s << lay.lane_shift) + l0;
    n = lay.n_z;
  } else {
    *in_y = true;
    const int t = s - lay.steps_z;
    const int k = t / lay.steps_per;
    base = b * lay.n_y + k * lay.n_per;
    j = ((t - k * lay.steps_per) << lay.lane_shift) + l0;
    n = lay.n_per;
  }
  const int lanes = lay.n_lanes < 32 ? lay.n_lanes : 32;
  *valid = n - j < 0 ? 0 : (n - j < lanes ? n - j : lanes);
  return base + j;
}
