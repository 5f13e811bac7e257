// MD trajectory file I/O: XTC (big-endian XDR, compressed coordinates) and
// DCD (CHARMM/NAMD little-endian Fortran records). C ABI for ctypes.
//
// Replaces the MDAnalysis C trajectory readers/writers the reference relies
// on (SURVEY.md section 2, L0; reference contacts.py uses XTC input and
// kinetics.py:106-125 writes XTC).
//
// Conventions: coordinates/box cross this ABI in the file's native length
// unit (XTC: nm, DCD: Angstrom); times in ps. The Python layer normalizes
// to Angstrom/ns.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "xdrf.h"

namespace {

constexpr int32_t XTC_MAGIC = 1995;

// ------------------------- big-endian XDR file I/O ---------------------- //

bool read_be32(FILE* f, uint32_t* v) {
    uint8_t b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    *v = (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
         (uint32_t(b[2]) << 8) | uint32_t(b[3]);
    return true;
}

bool write_be32(FILE* f, uint32_t v) {
    uint8_t b[4] = {uint8_t(v >> 24), uint8_t(v >> 16), uint8_t(v >> 8),
                    uint8_t(v)};
    return fwrite(b, 1, 4, f) == 4;
}

bool read_int(FILE* f, int32_t* v) {
    uint32_t u;
    if (!read_be32(f, &u)) return false;
    *v = int32_t(u);
    return true;
}

bool read_float(FILE* f, float* v) {
    uint32_t u;
    if (!read_be32(f, &u)) return false;
    std::memcpy(v, &u, 4);
    return true;
}

bool write_int(FILE* f, int32_t v) { return write_be32(f, uint32_t(v)); }

bool write_float(FILE* f, float v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    return write_be32(f, u);
}

// ------------------------------- XTC ------------------------------------ //

struct XtcHandle {
    FILE* f = nullptr;
    std::string path;
    int natoms = 0;
    std::vector<long> offsets;  // frame start byte offsets
};

// Parse one frame header at the current position and skip the payload.
// Returns false at EOF / malformed frame.
bool xtc_skip_frame(FILE* f, int* natoms_out) {
    int32_t magic, natoms, step;
    float time;
    if (!read_int(f, &magic)) return false;
    if (magic != XTC_MAGIC) return false;
    if (!read_int(f, &natoms) || !read_int(f, &step) ||
        !read_float(f, &time))
        return false;
    if (fseek(f, 9 * 4, SEEK_CUR) != 0) return false;  // box
    int32_t natoms2;
    if (!read_int(f, &natoms2) || natoms2 != natoms) return false;
    if (natoms <= 9) {
        if (fseek(f, long(natoms) * 3 * 4, SEEK_CUR) != 0) return false;
    } else {
        // precision + minint[3] + maxint[3] + smallidx + nbytes
        if (fseek(f, 9 * 4, SEEK_CUR) != 0) return false;
        long back = ftell(f) - 4;
        if (fseek(f, back, SEEK_SET) != 0) return false;
        int32_t nbytes;
        if (!read_int(f, &nbytes)) return false;
        long padded = (long(nbytes) + 3) & ~3L;  // XDR opaque padding
        if (fseek(f, padded, SEEK_CUR) != 0) return false;
    }
    *natoms_out = natoms;
    return true;
}

}  // namespace

extern "C" {

void* bmd_xtc_open(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    auto* h = new XtcHandle;
    h->f = f;
    h->path = path;
    long pos = 0;
    int natoms = 0;
    while (true) {
        if (fseek(f, pos, SEEK_SET) != 0) break;
        long start = pos;
        if (!xtc_skip_frame(f, &natoms)) break;
        if (h->natoms == 0) h->natoms = natoms;
        if (natoms != h->natoms) break;  // inconsistent file
        h->offsets.push_back(start);
        pos = ftell(f);
    }
    if (h->offsets.empty()) {
        fclose(f);
        delete h;
        return nullptr;
    }
    return h;
}

int bmd_xtc_natoms(void* vh) { return static_cast<XtcHandle*>(vh)->natoms; }

long bmd_xtc_nframes(void* vh) {
    return long(static_cast<XtcHandle*>(vh)->offsets.size());
}

// Read one frame from an already-positioned stream into the i-th slot.
static int xtc_read_one(FILE* f, const XtcHandle* h, long i, float* coords,
                        float* times, int* steps, float* box,
                        std::vector<uint8_t>& payload) {
    int32_t magic, natoms, step;
    float time;
    if (!read_int(f, &magic) || magic != XTC_MAGIC) return -3;
    if (!read_int(f, &natoms) || !read_int(f, &step) ||
        !read_float(f, &time))
        return -3;
    times[i] = time;
    steps[i] = step;
    for (int k = 0; k < 9; k++)
        if (!read_float(f, &box[i * 9 + k])) return -3;
    int32_t natoms2;
    if (!read_int(f, &natoms2)) return -3;
    float* out = coords + size_t(i) * h->natoms * 3;
    if (natoms <= 9) {
        for (int k = 0; k < natoms * 3; k++)
            if (!read_float(f, &out[k])) return -3;
    } else {
        float precision;
        int32_t minint[3], maxint[3], smallidx, nbytes;
        if (!read_float(f, &precision)) return -3;
        for (int d = 0; d < 3; d++)
            if (!read_int(f, &minint[d])) return -3;
        for (int d = 0; d < 3; d++)
            if (!read_int(f, &maxint[d])) return -3;
        if (!read_int(f, &smallidx) || !read_int(f, &nbytes)) return -3;
        payload.resize(size_t(nbytes));
        if (fread(payload.data(), 1, size_t(nbytes), f) != size_t(nbytes))
            return -3;
        int got = xdrf::decompress_coords(payload.data(), payload.size(),
                                          natoms, precision, minint,
                                          maxint, smallidx, out);
        if (got != natoms) return -4;
    }
    return 0;
}

// Read `count` frames at the given frame indices. coords: (count*natoms*3)
// floats in nm; times: ps; box: (count*9) nm. Returns frames read or <0.
// Frames decode in parallel (each worker owns its own stream); the XDR
// payloads are independent once the offset index exists.
long bmd_xtc_read(void* vh, const long* frame_idx, long count, float* coords,
                  float* times, int* steps, float* box) {
    auto* h = static_cast<XtcHandle*>(vh);
    unsigned hw = std::thread::hardware_concurrency();
    long nthreads = std::min<long>(count, hw > 1 ? hw : 1);

    auto worker = [&](long tid, FILE* f, int* status) {
        std::vector<uint8_t> payload;
        for (long i = tid; i < count; i += nthreads) {
            long fi = frame_idx[i];
            if (fi < 0 || fi >= long(h->offsets.size())) { *status = -1;
                return; }
            if (fseek(f, h->offsets[size_t(fi)], SEEK_SET) != 0) {
                *status = -2;
                return;
            }
            int rc = xtc_read_one(f, h, i, coords, times, steps, box,
                                  payload);
            if (rc != 0) { *status = rc; return; }
        }
        *status = 0;
    };

    if (nthreads <= 1) {
        int status = 0;
        worker(0, h->f, &status);
        return status == 0 ? count : status;
    }
    std::vector<std::thread> threads;
    std::vector<int> status(size_t(nthreads), 0);
    std::vector<FILE*> files(size_t(nthreads), nullptr);
    for (long t = 0; t < nthreads; t++) {
        files[size_t(t)] = fopen(h->path.c_str(), "rb");
        if (!files[size_t(t)]) { nthreads = t; break; }
    }
    for (long t = 0; t < nthreads; t++)
        threads.emplace_back(worker, t, files[size_t(t)],
                             &status[size_t(t)]);
    for (auto& th : threads) th.join();
    int rc = 0;
    for (long t = 0; t < nthreads; t++) {
        if (status[size_t(t)] != 0) rc = status[size_t(t)];
        fclose(files[size_t(t)]);
    }
    return rc == 0 ? count : rc;
}

void bmd_xtc_close(void* vh) {
    auto* h = static_cast<XtcHandle*>(vh);
    fclose(h->f);
    delete h;
}

// Append/write frames. coords in nm, times in ps, box (nframes*9) in nm.
long bmd_xtc_write(const char* path, int natoms, long nframes,
                   const float* coords, const float* times, const int* steps,
                   const float* box, float precision, int append) {
    FILE* f = fopen(path, append ? "ab" : "wb");
    if (!f) return -1;
    std::vector<uint8_t> payload;
    for (long i = 0; i < nframes; i++) {
        write_int(f, XTC_MAGIC);
        write_int(f, natoms);
        write_int(f, steps ? steps[i] : int(i));
        write_float(f, times[i]);
        for (int k = 0; k < 9; k++) write_float(f, box[i * 9 + k]);
        write_int(f, natoms);
        const float* frame = coords + size_t(i) * natoms * 3;
        if (natoms <= 9) {
            for (int k = 0; k < natoms * 3; k++) write_float(f, frame[k]);
        } else {
            int minint[3], maxint[3], smallidx;
            int nbytes = xdrf::compress_coords(frame, natoms, precision,
                                               payload, minint, maxint,
                                               &smallidx);
            if (nbytes < 0) {
                fclose(f);
                return -2;
            }
            write_float(f, precision);
            for (int d = 0; d < 3; d++) write_int(f, minint[d]);
            for (int d = 0; d < 3; d++) write_int(f, maxint[d]);
            write_int(f, smallidx);
            write_int(f, nbytes);
            fwrite(payload.data(), 1, size_t(nbytes), f);
            long pad = ((long(nbytes) + 3) & ~3L) - nbytes;
            const uint8_t zeros[4] = {0, 0, 0, 0};
            if (pad) fwrite(zeros, 1, size_t(pad), f);
        }
    }
    fclose(f);
    return nframes;
}

// ------------------------------- TRR ------------------------------------ //
// GROMACS TRR: big-endian XDR frames of uncompressed float/double arrays.
// Same wire encoding the XTC codec already speaks, minus the 3dfcoord
// compression. Layout per frame (trnio conventions):
//   int magic (1993)
//   string version: int (strlen+1), u32 strlen, bytes padded to 4
//   int ir_size, e_size, box_size, vir_size, pres_size, top_size,
//       sym_size, x_size, v_size, f_size, natoms, step, nre
//   real t, lambda               (real = double when the sizes say so)
//   payload: box, vir, pres, x, v, f  (each present iff its size > 0)

namespace {

struct TrrFrameInfo {
    long offset = 0;       // frame start
    long x_offset = 0;     // absolute offset of the x array (0 = absent)
    long box_offset = 0;   // absolute offset of the box (0 = absent)
    int step = 0;
    float time = 0.0f;
    bool is_double = false;
};

struct TrrHandle {
    FILE* f = nullptr;
    std::string path;
    int natoms = 0;
    std::vector<TrrFrameInfo> frames;
};

bool read_real(FILE* f, bool is_double, double* v) {
    if (is_double) {
        uint8_t b[8];
        if (fread(b, 1, 8, f) != 8) return false;
        uint64_t u = 0;
        for (int i = 0; i < 8; i++) u = (u << 8) | b[i];
        std::memcpy(v, &u, 8);
        return true;
    }
    float fv;
    if (!read_float(f, &fv)) return false;
    *v = fv;
    return true;
}

// Parse one TRR frame header at the current position; leaves the stream at
// the start of the payload. Returns false at EOF / malformed frame.
bool trr_read_header(FILE* f, int* natoms, TrrFrameInfo* info,
                     long sizes[6]) {
    int32_t magic;
    if (!read_int(f, &magic)) return false;
    if (magic != 1993) return false;
    // version string, two conventions in the wild (both 4 + 16 bytes for
    // "GMX_trn_file"): GROMACS-native writes int(strlen+1) then an XDR
    // string (u32 strlen + padded bytes); the xdrfile library (MDAnalysis,
    // mdtraj) writes int(strlen+1) then an opaque of strlen+1 padded
    // bytes. Disambiguate by whether the next word is a plausible length.
    int32_t n1;
    if (!read_int(f, &n1)) return false;      // strlen + 1
    if (n1 <= 0 || n1 > 64) return false;
    uint32_t peek;
    if (!read_be32(f, &peek)) return false;
    if (peek <= 64) {
        // XDR-string convention: peek is the string length
        long padded = (long(peek) + 3) & ~3L;
        if (fseek(f, padded, SEEK_CUR) != 0) return false;
    } else {
        // opaque convention: n1 bytes padded, 4 already consumed
        long padded = (long(n1) + 3) & ~3L;
        if (fseek(f, padded - 4, SEEK_CUR) != 0) return false;
    }
    int32_t v[13];
    for (int i = 0; i < 13; i++)
        if (!read_int(f, &v[i])) return false;
    const long box_size = v[2], vir_size = v[3], pres_size = v[4];
    const long x_size = v[7], v_size = v[8], f_size = v[9];
    *natoms = v[10];
    info->step = v[11];
    // double-precision file iff the per-element size says 8 bytes
    bool is_double = false;
    if (box_size) is_double = (box_size / 9 == 8);
    else if (x_size && *natoms > 0)
        is_double = (x_size / (long(*natoms) * 3) == 8);
    info->is_double = is_double;
    double t, lambda;
    if (!read_real(f, is_double, &t) || !read_real(f, is_double, &lambda))
        return false;
    info->time = float(t);
    sizes[0] = box_size;
    sizes[1] = vir_size;
    sizes[2] = pres_size;
    sizes[3] = x_size;
    sizes[4] = v_size;
    sizes[5] = f_size;
    return true;
}

}  // namespace

extern "C" {

void* bmd_trr_open(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    auto* h = new TrrHandle;
    h->f = f;
    h->path = path;
    long pos = 0;
    while (true) {
        if (fseek(f, pos, SEEK_SET) != 0) break;
        TrrFrameInfo info;
        info.offset = pos;
        int natoms = 0;
        long sizes[6];
        if (!trr_read_header(f, &natoms, &info, sizes)) break;
        if (h->natoms == 0) h->natoms = natoms;
        if (natoms != h->natoms) break;
        long at = ftell(f);
        info.box_offset = sizes[0] ? at : 0;
        at += sizes[0] + sizes[1] + sizes[2];
        info.x_offset = sizes[3] ? at : 0;
        at += sizes[3] + sizes[4] + sizes[5];
        h->frames.push_back(info);
        pos = at;
    }
    if (h->frames.empty()) {
        fclose(f);
        delete h;
        return nullptr;
    }
    return h;
}

int bmd_trr_natoms(void* vh) { return static_cast<TrrHandle*>(vh)->natoms; }

long bmd_trr_nframes(void* vh) {
    return long(static_cast<TrrHandle*>(vh)->frames.size());
}

// Read `count` frames. coords (count*natoms*3) floats [nm]; times ps;
// box (count*9) [nm] (zeros when absent); steps. Frames without coordinates
// fail with -5 (TRR frames may carry only velocities/forces).
long bmd_trr_read(void* vh, const long* frame_idx, long count, float* coords,
                  float* times, int* steps, float* box) {
    auto* h = static_cast<TrrHandle*>(vh);
    std::vector<uint8_t> buf;
    for (long i = 0; i < count; i++) {
        long fi = frame_idx[i];
        if (fi < 0 || fi >= long(h->frames.size())) return -1;
        const TrrFrameInfo& info = h->frames[size_t(fi)];
        times[i] = info.time;
        steps[i] = info.step;
        const int esz = info.is_double ? 8 : 4;
        float* bx = box + i * 9;
        std::memset(bx, 0, 9 * sizeof(float));
        if (info.box_offset) {
            if (fseek(h->f, info.box_offset, SEEK_SET) != 0) return -2;
            buf.resize(size_t(9) * esz);
            if (fread(buf.data(), 1, buf.size(), h->f) != buf.size())
                return -3;
            for (int k = 0; k < 9; k++) {
                const uint8_t* b = buf.data() + size_t(k) * esz;
                if (info.is_double) {
                    uint64_t u = 0;
                    for (int j = 0; j < 8; j++) u = (u << 8) | b[j];
                    double d;
                    std::memcpy(&d, &u, 8);
                    bx[k] = float(d);
                } else {
                    uint32_t u = (uint32_t(b[0]) << 24) |
                                 (uint32_t(b[1]) << 16) |
                                 (uint32_t(b[2]) << 8) | b[3];
                    std::memcpy(&bx[k], &u, 4);
                }
            }
        }
        if (!info.x_offset) return -5;
        if (fseek(h->f, info.x_offset, SEEK_SET) != 0) return -2;
        const size_t n = size_t(h->natoms) * 3;
        buf.resize(n * esz);
        if (fread(buf.data(), 1, buf.size(), h->f) != buf.size()) return -3;
        float* out = coords + size_t(i) * n;
        for (size_t k = 0; k < n; k++) {
            const uint8_t* b = buf.data() + k * esz;
            if (info.is_double) {
                uint64_t u = 0;
                for (int j = 0; j < 8; j++) u = (u << 8) | b[j];
                double d;
                std::memcpy(&d, &u, 8);
                out[k] = float(d);
            } else {
                uint32_t u = (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
                             (uint32_t(b[2]) << 8) | b[3];
                std::memcpy(&out[k], &u, 4);
            }
        }
    }
    return count;
}

void bmd_trr_close(void* vh) {
    auto* h = static_cast<TrrHandle*>(vh);
    fclose(h->f);
    delete h;
}

// Write single-precision TRR frames carrying box + x only (the subset the
// pipeline produces). coords [nm], times [ps], box (nframes*9) [nm].
long bmd_trr_write(const char* path, int natoms, long nframes,
                   const float* coords, const float* times, const int* steps,
                   const float* box, int append) {
    FILE* f = fopen(path, append ? "ab" : "wb");
    if (!f) return -1;
    const char* version = "GMX_trn_file";
    const uint32_t slen = uint32_t(std::strlen(version));
    for (long i = 0; i < nframes; i++) {
        write_int(f, 1993);
        // xdrfile-library string convention: int(strlen+1), then the
        // null-terminated bytes as an XDR opaque (padded to 4)
        write_int(f, int32_t(slen) + 1);
        fwrite(version, 1, slen + 1, f);       // includes the NUL
        const long pad = ((long(slen) + 1 + 3) & ~3L) - long(slen) - 1;
        const uint8_t zeros[4] = {0, 0, 0, 0};
        if (pad) fwrite(zeros, 1, size_t(pad), f);
        const long x_size = long(natoms) * 3 * 4;
        const int32_t v[13] = {0, 0, 9 * 4, 0, 0, 0, 0, int32_t(x_size), 0,
                               0, natoms, steps ? steps[i] : int32_t(i), 0};
        for (int k = 0; k < 13; k++) write_int(f, v[k]);
        write_float(f, times[i]);
        write_float(f, 0.0f);  // lambda
        for (int k = 0; k < 9; k++) write_float(f, box[i * 9 + k]);
        const float* frame = coords + size_t(i) * natoms * 3;
        for (long k = 0; k < long(natoms) * 3; k++)
            write_float(f, frame[k]);
    }
    fclose(f);
    return nframes;
}

}  // extern "C" (bmd_trr_*)

// ------------------------------- DCD ------------------------------------ //
// Minimal CHARMM-style DCD with unit-cell records, little-endian host order.

struct DcdHandle {
    FILE* f = nullptr;
    int natoms = 0;
    long nframes = 0;
    long first_frame_off = 0;
    long frame_bytes = 0;
    bool has_cell = false;
    float delta = 0.0f;  // timestep as stored (AKMA units for CHARMM files)
    int istart = 0, nsavc = 1;
    int charmm = 0;      // icntrl[19]: nonzero marks a CHARMM-format file
};

static bool read_rec(FILE* f, std::vector<uint8_t>& buf) {
    uint32_t n1, n2;
    if (fread(&n1, 4, 1, f) != 1) return false;
    buf.resize(n1);
    if (n1 && fread(buf.data(), 1, n1, f) != n1) return false;
    if (fread(&n2, 4, 1, f) != 1) return false;
    return n1 == n2;
}

static bool write_rec(FILE* f, const void* data, uint32_t n) {
    if (fwrite(&n, 4, 1, f) != 1) return false;
    if (n && fwrite(data, 1, n, f) != n) return false;
    return fwrite(&n, 4, 1, f) == 1;
}

extern "C" void* bmd_dcd_open(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    auto* h = new DcdHandle;
    h->f = f;
    std::vector<uint8_t> rec;
    if (!read_rec(f, rec) || rec.size() < 84 ||
        std::memcmp(rec.data(), "CORD", 4) != 0) {
        fclose(f);
        delete h;
        return nullptr;
    }
    const int32_t* icntrl = reinterpret_cast<const int32_t*>(rec.data() + 4);
    h->nframes = icntrl[0];
    h->istart = icntrl[1];
    h->nsavc = icntrl[2];
    std::memcpy(&h->delta, &icntrl[9], 4);
    h->has_cell = icntrl[10] != 0;
    h->charmm = icntrl[19];
    if (!read_rec(f, rec)) { fclose(f); delete h; return nullptr; }  // title
    if (!read_rec(f, rec) || rec.size() != 4) {
        fclose(f);
        delete h;
        return nullptr;
    }
    std::memcpy(&h->natoms, rec.data(), 4);
    h->first_frame_off = ftell(f);
    long coord_rec = 4 + long(h->natoms) * 4 + 4;
    h->frame_bytes = 3 * coord_rec + (h->has_cell ? (4 + 48 + 4) : 0);
    // trust the file size over the header's frame count
    fseek(f, 0, SEEK_END);
    long end = ftell(f);
    h->nframes = (end - h->first_frame_off) / h->frame_bytes;
    return h;
}

extern "C" int bmd_dcd_natoms(void* vh) {
    return static_cast<DcdHandle*>(vh)->natoms;
}
extern "C" long bmd_dcd_nframes(void* vh) {
    return static_cast<DcdHandle*>(vh)->nframes;
}
extern "C" float bmd_dcd_delta(void* vh) {
    return static_cast<DcdHandle*>(vh)->delta;
}
extern "C" int bmd_dcd_nsavc(void* vh) {
    return static_cast<DcdHandle*>(vh)->nsavc;
}
extern "C" int bmd_dcd_charmm(void* vh) {
    return static_cast<DcdHandle*>(vh)->charmm;
}

// coords in Angstrom (count*natoms*3); box (count*6) as stored (unitcell
// record: [A, gamma_cos, B, beta_cos, alpha_cos, C]).
extern "C" long bmd_dcd_read(void* vh, const long* frame_idx, long count,
                             float* coords, double* box) {
    auto* h = static_cast<DcdHandle*>(vh);
    std::vector<uint8_t> rec;
    std::vector<float> tmp(static_cast<size_t>(h->natoms));
    for (long i = 0; i < count; i++) {
        long fi = frame_idx[i];
        if (fi < 0 || fi >= h->nframes) return -1;
        fseek(h->f, h->first_frame_off + fi * h->frame_bytes, SEEK_SET);
        if (h->has_cell) {
            if (!read_rec(h->f, rec) || rec.size() != 48) return -2;
            std::memcpy(&box[i * 6], rec.data(), 48);
        } else {
            std::memset(&box[i * 6], 0, 48);
        }
        float* out = coords + size_t(i) * h->natoms * 3;
        for (int d = 0; d < 3; d++) {
            if (!read_rec(h->f, rec) ||
                rec.size() != size_t(h->natoms) * 4)
                return -3;
            std::memcpy(tmp.data(), rec.data(), size_t(h->natoms) * 4);
            for (int a = 0; a < h->natoms; a++) out[a * 3 + d] = tmp[a];
        }
    }
    return count;
}

extern "C" void bmd_dcd_close(void* vh) {
    auto* h = static_cast<DcdHandle*>(vh);
    fclose(h->f);
    delete h;
}

// Write a DCD: coords Angstrom, box as 6-double unitcell rows or null.
extern "C" long bmd_dcd_write(const char* path, int natoms, long nframes,
                              const float* coords, const double* box,
                              float delta, int istart, int nsavc) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    uint8_t header[84] = {0};
    std::memcpy(header, "CORD", 4);
    int32_t* icntrl = reinterpret_cast<int32_t*>(header + 4);
    icntrl[0] = int32_t(nframes);
    icntrl[1] = istart;
    icntrl[2] = nsavc;
    icntrl[3] = int32_t(nframes) * nsavc;
    std::memcpy(&icntrl[9], &delta, 4);
    icntrl[10] = box ? 1 : 0;
    icntrl[19] = 24;  // CHARMM version stamp
    write_rec(f, header, 84);
    char title[84] = {0};
    int32_t ntitle = 1;
    std::memcpy(title, &ntitle, 4);
    std::snprintf(title + 4, 80, "Created by basicrta_tpu");
    write_rec(f, title, 84);
    int32_t na = natoms;
    write_rec(f, &na, 4);
    std::vector<float> tmp(static_cast<size_t>(natoms));
    for (long i = 0; i < nframes; i++) {
        if (box) write_rec(f, &box[i * 6], 48);
        const float* frame = coords + size_t(i) * natoms * 3;
        for (int d = 0; d < 3; d++) {
            for (int a = 0; a < natoms; a++) tmp[a] = frame[a * 3 + d];
            write_rec(f, tmp.data(), uint32_t(natoms) * 4);
        }
    }
    fclose(f);
    return nframes;
}

}  // extern "C" (bmd_xtc_*)
