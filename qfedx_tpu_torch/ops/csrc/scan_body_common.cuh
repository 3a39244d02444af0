// Shared by both instances of the scan-body kernel (scan_body.cu): the
// slab geometry, the int32 descriptor layout the wrapper writes
// (ops/scan_body.py::_layout) and the op kind codes (_KIND_CODE there).
#pragma once

namespace qfx {

constexpr int LANES = 128;
constexpr int LANE_BITS = 7;
constexpr int DESC_W = 8;

// Descriptor fields.
constexpr int D_KIND = 0;    // op kind code (below)
constexpr int D_Q0 = 1;      // first qubit (control for glane/growmat/cnot)
constexpr int D_Q1 = 2;      // second qubit (rowpair q2, cnot target)
constexpr int D_RE = 3;      // offset of the re coefficients (floats)
constexpr int D_IM = 4;      // offset of the im coefficients, -1 = real
constexpr int D_GROUPS = 5;  // coefficient groups G (G divides tb)
constexpr int D_GSIZE = 6;   // floats per (layer, group) gate
constexpr int D_STATIC = 7;  // offset into the int32 statics (rowperm)

enum Kind {
  K_LANE = 0,
  K_ROWMAT = 1,
  K_MASK = 2,
  K_GLANE = 3,
  K_GROWMAT = 4,
  K_ROWPERM = 5,
  K_ROWPAIR = 6,
  K_CNOT = 7,
};

}  // namespace qfx
