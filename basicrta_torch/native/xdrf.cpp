// XDR compressed-coordinate codec (the GROMACS XTC "3dfcoord" scheme) and
// XTC/TRR-style big-endian XDR primitives, implemented from the published
// format specification (https://manual.gromacs.org/current/reference-manual/
// file-formats.html#xtc and the libxdrf algorithm description).
//
// Replaces the trajectory-reader C code the reference uses through
// MDAnalysis (SURVEY.md section 2, L0 native deps). Exposed to Python via a
// plain C ABI (ctypes); see native/mdio.cpp for the file-level API.

#include <cstdint>
#include <climits>
#include <cstring>
#include <cmath>
#include <vector>

#include "xdrf.h"

namespace xdrf {

// Magic integer ladder of the 3dfcoord scheme: candidate range sizes such
// that ranges grow by ~factor 2^(1/3) per index, so each index step adds
// one bit per 3 ints.
static const int magicints[] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290,
    1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384,
    20642, 26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072,
    165140, 208063, 262144, 330280, 416127, 524287, 660561, 832255,
    1048576, 1321122, 1664510, 2097152, 2642245, 3329021, 4194304,
    5284491, 6658042, 8388607, 10568983, 13316085, 16777216};

static const int FIRSTIDX = 9;
static const int LASTIDX = int(sizeof(magicints) / sizeof(int));

// ---------------------------------------------------------------------- //
// Bit-level buffer helpers. The XDR stream stores the compressed block as
// a byte array; bits fill bytes MSB-first.

struct BitBuf {
    std::vector<uint8_t>& data;
    size_t bytepos = 0;
    int bitpos = 0;  // bits already used in data[bytepos]
    explicit BitBuf(std::vector<uint8_t>& d) : data(d) {}
};

static void sendbits(BitBuf& buf, int nbits, unsigned int value) {
    while (nbits > 0) {
        if (buf.bytepos >= buf.data.size()) buf.data.push_back(0);
        int free_bits = 8 - buf.bitpos;
        int take = nbits < free_bits ? nbits : free_bits;
        unsigned int chunk = (value >> (nbits - take)) & ((1u << take) - 1);
        buf.data[buf.bytepos] |= uint8_t(chunk << (free_bits - take));
        buf.bitpos += take;
        nbits -= take;
        if (buf.bitpos == 8) { buf.bytepos++; buf.bitpos = 0; }
    }
}

static unsigned int receivebits(BitBuf& buf, int nbits) {
    unsigned int value = 0;
    while (nbits > 0) {
        int avail = 8 - buf.bitpos;
        int take = nbits < avail ? nbits : avail;
        uint8_t byte = buf.bytepos < buf.data.size() ? buf.data[buf.bytepos]
                                                     : 0;
        unsigned int chunk = (byte >> (avail - take)) & ((1u << take) - 1);
        value = (value << take) | chunk;
        buf.bitpos += take;
        nbits -= take;
        if (buf.bitpos == 8) { buf.bytepos++; buf.bitpos = 0; }
    }
    return value;
}

static int sizeofint(int size) {
    int num = 1, nbits = 0;
    while (size >= num && nbits < 32) { nbits++; num <<= 1; }
    return nbits;
}

// number of bits needed for nints ints with given sizes, via the
// multi-precision product of the sizes
static int sizeofints(int nints, const unsigned int sizes[]) {
    unsigned int bytes[32];
    int nbytes = 1;
    bytes[0] = 1;
    unsigned int bytecnt;
    for (int i = 0; i < nints; i++) {
        unsigned int tmp = 0;
        for (bytecnt = 0; bytecnt < unsigned(nbytes); bytecnt++) {
            tmp += bytes[bytecnt] * sizes[i];
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        nbytes = int(bytecnt);
    }
    int num = 1, nbits = 0;
    nbytes--;
    while (int(bytes[nbytes]) >= num) { nbits++; num *= 2; }
    return nbits + nbytes * 8;
}

// pack nints small ints (each < sizes[i]) into nbits via multi-precision
// arithmetic, then send the bits
static void sendints(BitBuf& buf, int nints, int nbits,
                     const unsigned int sizes[], const unsigned int nums[]) {
    unsigned int bytes[32];
    int nbytes = 0;
    unsigned int tmp = nums[0];
    do { bytes[nbytes++] = tmp & 0xff; tmp >>= 8; } while (tmp != 0);
    for (int i = 1; i < nints; i++) {
        // multiply current value by sizes[i] and add nums[i]
        tmp = nums[i];
        unsigned int bytecnt;
        for (bytecnt = 0; bytecnt < unsigned(nbytes); bytecnt++) {
            tmp += bytes[bytecnt] * sizes[i];
            bytes[bytecnt] = tmp & 0xff;
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bytecnt++] = tmp & 0xff;
            tmp >>= 8;
        }
        nbytes = int(bytecnt);
    }
    if (nbits >= nbytes * 8) {
        for (int i = 0; i < nbytes; i++) sendbits(buf, 8, bytes[i]);
        sendbits(buf, nbits - nbytes * 8, 0);
    } else {
        int i;
        for (i = 0; i < nbytes - 1; i++) sendbits(buf, 8, bytes[i]);
        sendbits(buf, nbits - (nbytes - 1) * 8, bytes[i]);
    }
}

static void receiveints(BitBuf& buf, int nints, int nbits,
                        const unsigned int sizes[], int nums[]) {
    unsigned int bytes[32] = {0, 0, 0, 0};
    int nbytes = 0;
    while (nbits > 8) {
        // note: bits arrive most-significant byte LAST in this scheme
        bytes[nbytes++] = receivebits(buf, 8);
        nbits -= 8;
    }
    if (nbits > 0) bytes[nbytes++] = receivebits(buf, nbits);
    for (int i = nints - 1; i > 0; i--) {
        unsigned int num = 0;
        for (int j = nbytes - 1; j >= 0; j--) {
            num = (num << 8) | bytes[j];
            unsigned int p = num / sizes[i];
            bytes[j] = p;
            num = num - p * sizes[i];
        }
        nums[i] = int(num);
    }
    nums[0] = int(bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) |
                  (bytes[3] << 24));
}

// ---------------------------------------------------------------------- //
// 3dfcoord compression: quantize to ints, delta/run-length encode with an
// adaptive small-range ("smallidx") ladder.

int compress_coords(const float* coords, int natoms, float precision,
                    std::vector<uint8_t>& out, int minint[3], int maxint[3],
                    int* smallidx_out) {
    out.clear();
    if (natoms <= 9) return -1;  // caller stores plain floats
    std::vector<int> ip(size_t(natoms) * 3);
    minint[0] = minint[1] = minint[2] = INT32_MAX;
    maxint[0] = maxint[1] = maxint[2] = INT32_MIN;

    const float maxf = float(INT32_MAX - 2);
    for (int i = 0; i < natoms; i++) {
        for (int d = 0; d < 3; d++) {
            float lf = coords[i * 3 + d] * precision;
            if (std::fabs(lf) > maxf) return -2;  // overflow
            int lint = int(std::lround(lf));
            ip[size_t(i) * 3 + d] = lint;
            if (lint < minint[d]) minint[d] = lint;
            if (lint > maxint[d]) maxint[d] = lint;
        }
    }

    unsigned int sizeint[3], bitsizeint[3] = {0, 0, 0};
    for (int d = 0; d < 3; d++)
        sizeint[d] = unsigned(maxint[d] - minint[d]) + 1;
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        for (int d = 0; d < 3; d++)
            bitsizeint[d] = sizeofint(int(sizeint[d]));
        bitsize = 0;  // flag: use independent sizes
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    int smallidx = FIRSTIDX;
    while (smallidx < LASTIDX - 1 && magicints[smallidx] < bitsize)
        smallidx++;
    *smallidx_out = smallidx;

    // header ints are written by the caller (minint/maxint/smallidx);
    // here we produce only the bit-packed payload
    BitBuf buf(out);

    int maxidx = std::min(LASTIDX - 1, smallidx + 8);
    int minidx = maxidx - 8;
    int smaller = magicints[std::max(FIRSTIDX, smallidx - 1)] / 2;
    int smallnum = magicints[smallidx] / 2;
    unsigned int sizesmall[3] = {unsigned(magicints[smallidx]),
                                 unsigned(magicints[smallidx]),
                                 unsigned(magicints[smallidx])};
    int larger = magicints[maxidx] / 2;

    (void)minidx;
    (void)larger;
    (void)smaller;
    int prevcoord[3] = {0, 0, 0};
    int prevrun = -1;
    int tmpcoord[30];
    int i = 0;
    while (i < natoms) {
        bool is_small = false;
        int* thiscoord = &ip[size_t(i) * 3];
        // this encoder never changes smallidx mid-stream (is_smaller = 0
        // always) — grammatically valid, marginally less compact than the
        // adaptive canonical encoder; decoders handle both.
        const int is_smaller = 0;

        if (i + 1 < natoms) {
            int* next = &ip[size_t(i + 1) * 3];
            if (std::abs(next[0] - thiscoord[0]) < smallnum &&
                std::abs(next[1] - thiscoord[1]) < smallnum &&
                std::abs(next[2] - thiscoord[2]) < smallnum) {
                // swap current/next in place: the header stores the second
                // atom, the first run delta recovers the first atom
                for (int d = 0; d < 3; d++) {
                    int t = thiscoord[d];
                    thiscoord[d] = next[d];
                    next[d] = t;
                }
                is_small = true;
            }
        }
        tmpcoord[0] = thiscoord[0] - minint[0];
        tmpcoord[1] = thiscoord[1] - minint[1];
        tmpcoord[2] = thiscoord[2] - minint[2];
        if (bitsize == 0) {
            sendbits(buf, int(bitsizeint[0]), unsigned(tmpcoord[0]));
            sendbits(buf, int(bitsizeint[1]), unsigned(tmpcoord[1]));
            sendbits(buf, int(bitsizeint[2]), unsigned(tmpcoord[2]));
        } else {
            sendints(buf, 3, bitsize, sizeint,
                     reinterpret_cast<unsigned int*>(tmpcoord));
        }
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];
        i++;

        int run = 0;
        while (is_small && run < 8 * 3) {
            thiscoord = &ip[size_t(i) * 3];
            tmpcoord[run++] = thiscoord[0] - prevcoord[0] + smallnum;
            tmpcoord[run++] = thiscoord[1] - prevcoord[1] + smallnum;
            tmpcoord[run++] = thiscoord[2] - prevcoord[2] + smallnum;
            prevcoord[0] = thiscoord[0];
            prevcoord[1] = thiscoord[1];
            prevcoord[2] = thiscoord[2];
            i++;
            is_small = i < natoms &&
                std::abs(ip[size_t(i) * 3 + 0] - prevcoord[0]) < smallnum &&
                std::abs(ip[size_t(i) * 3 + 1] - prevcoord[1]) < smallnum &&
                std::abs(ip[size_t(i) * 3 + 2] - prevcoord[2]) < smallnum;
        }
        if (run != prevrun || is_smaller != 0) {
            prevrun = run;
            sendbits(buf, 1, 1);  // flag: runbits follow
            sendbits(buf, 5, unsigned(run + is_smaller + 1));
        } else {
            sendbits(buf, 1, 0);
        }
        for (int k = 0; k < run; k += 3) {
            sendints(buf, 3, sizeofints(3, sizesmall), sizesmall,
                     reinterpret_cast<unsigned int*>(&tmpcoord[k]));
        }
    }
    return int(buf.bytepos + (buf.bitpos > 0 ? 1 : 0));
}

int decompress_coords(const uint8_t* data, size_t nbytes, int natoms,
                      float precision, const int minint[3],
                      const int maxint[3], int smallidx, float* coords) {
    std::vector<uint8_t> vec(data, data + nbytes);
    BitBuf buf(vec);

    unsigned int sizeint[3], bitsizeint[3] = {0, 0, 0};
    for (int d = 0; d < 3; d++)
        sizeint[d] = unsigned(maxint[d] - minint[d]) + 1;
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffff) {
        for (int d = 0; d < 3; d++)
            bitsizeint[d] = sizeofint(int(sizeint[d]));
        bitsize = 0;
    } else {
        bitsize = sizeofints(3, sizeint);
    }

    int maxidx = std::min(LASTIDX - 1, smallidx + 8);
    int minidx = maxidx - 8;
    (void)minidx;
    int smaller = magicints[std::max(FIRSTIDX, smallidx - 1)] / 2;
    int smallnum = magicints[smallidx] / 2;
    unsigned int sizesmall[3] = {unsigned(magicints[smallidx]),
                                 unsigned(magicints[smallidx]),
                                 unsigned(magicints[smallidx])};

    float inv_precision = 1.0f / precision;
    int run = 0;
    int i = 0;
    int prevcoord[3] = {0, 0, 0};
    int thiscoord[3];

    while (i < natoms) {
        if (bitsize == 0) {
            thiscoord[0] = int(receivebits(buf, int(bitsizeint[0])));
            thiscoord[1] = int(receivebits(buf, int(bitsizeint[1])));
            thiscoord[2] = int(receivebits(buf, int(bitsizeint[2])));
        } else {
            receiveints(buf, 3, bitsize, sizeint, thiscoord);
        }
        thiscoord[0] += minint[0];
        thiscoord[1] += minint[1];
        thiscoord[2] += minint[2];
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];

        unsigned int flag = receivebits(buf, 1);
        int is_smaller = 0;
        if (flag == 1) {
            run = int(receivebits(buf, 5));
            is_smaller = run % 3;
            run -= is_smaller;
            is_smaller--;
        }
        if (run > 0) {
            // the first value of the run pair was swapped at encode time:
            // the atom written above actually comes second
            float* out2 = &coords[size_t(i) * 3];
            i++;
            for (int k = 0; k < run; k += 3) {
                int tmp[3];
                receiveints(buf, 3, sizeofints(3, sizesmall), sizesmall,
                            tmp);
                thiscoord[0] = tmp[0] + prevcoord[0] - smallnum;
                thiscoord[1] = tmp[1] + prevcoord[1] - smallnum;
                thiscoord[2] = tmp[2] + prevcoord[2] - smallnum;
                if (k == 0) {
                    // swap back: delta atom precedes the header atom
                    int t0 = thiscoord[0], t1 = thiscoord[1],
                        t2 = thiscoord[2];
                    thiscoord[0] = prevcoord[0];
                    thiscoord[1] = prevcoord[1];
                    thiscoord[2] = prevcoord[2];
                    prevcoord[0] = t0; prevcoord[1] = t1; prevcoord[2] = t2;
                    out2[0] = prevcoord[0] * inv_precision;
                    out2[1] = prevcoord[1] * inv_precision;
                    out2[2] = prevcoord[2] * inv_precision;
                } else {
                    prevcoord[0] = thiscoord[0];
                    prevcoord[1] = thiscoord[1];
                    prevcoord[2] = thiscoord[2];
                }
                coords[size_t(i) * 3 + 0] = thiscoord[0] * inv_precision;
                coords[size_t(i) * 3 + 1] = thiscoord[1] * inv_precision;
                coords[size_t(i) * 3 + 2] = thiscoord[2] * inv_precision;
                i++;
            }
        } else {
            coords[size_t(i) * 3 + 0] = thiscoord[0] * inv_precision;
            coords[size_t(i) * 3 + 1] = thiscoord[1] * inv_precision;
            coords[size_t(i) * 3 + 2] = thiscoord[2] * inv_precision;
            i++;
        }
        smallidx += is_smaller;
        if (is_smaller < 0) {
            smallnum = smaller;
            smaller = (smallidx > FIRSTIDX) ? magicints[smallidx - 1] / 2
                                            : 0;
        } else if (is_smaller > 0) {
            smaller = smallnum;
            smallnum = magicints[smallidx] / 2;
        }
        if (is_smaller != 0)
            sizesmall[0] = sizesmall[1] = sizesmall[2] =
                unsigned(magicints[smallidx]);
    }
    return i;
}

}  // namespace xdrf
