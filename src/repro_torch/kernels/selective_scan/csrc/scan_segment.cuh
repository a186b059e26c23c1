// The steps between two states that the selective-scan forward keeps for
// its backward (selective_scan.cu's ``states``: the state entering every
// kSeg-th step), which is the backward's segment (selective_scan_bwd.cu,
// whose note says why 4). selective_scan.py's STATE_EVERY is the same
// number, for the shape of ``states``.
#pragma once

constexpr int kSeg = 4;
