// XDR 3dfcoord codec interface (see xdrf.cpp).
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace xdrf {

// Quantize and compress natoms*3 floats. Fills the payload bytes and the
// header fields (minint/maxint/smallidx) the XTC frame header stores.
// Returns payload byte count, or <0 on error (-1: too few atoms for
// compression; -2: coordinate overflow at this precision).
int compress_coords(const float* coords, int natoms, float precision,
                    std::vector<uint8_t>& out, int minint[3], int maxint[3],
                    int* smallidx);

// Inverse of compress_coords. Returns the number of atoms decoded.
int decompress_coords(const uint8_t* data, size_t nbytes, int natoms,
                      float precision, const int minint[3],
                      const int maxint[3], int smallidx, float* coords);

}  // namespace xdrf
