// Native host ops of omnihd_scenes_tpu_torch: the radar sweep decode of
// the host feed and the greedy rotated NMS of tools.test --host-nms.
//
// The radar and NMS parts of the JAX package's csrc/host_ops.cpp, copied
// function for function (load_f32_bin, radar_compensate; poly_area,
// clip_halfplane, rotated_iou, nms_rotated_multiclass), so a sweep decodes
// to the same rows and an NMS keeps the same boxes bit for bit when both
// are built alike.  The radar part is the hot per-sweep pipeline: load the
// .bin, ego-motion Doppler compensation, rotation into the lidar frame
// (parity with LoadRadarPointsMultiSweeps, reference
// loading.py:116-316).  The range crop and the remap of the JAX package's
// library are not carried over: nothing in the port calls them (the
// port's camera remap is the rectify kernel on the card, whose border rule
// is cv2.remap's, not remap_bilinear_u8's).
//
// Built by data/native.py at first use: g++ -O3 -shared -fPIC.
// C ABI only; loaded via ctypes.  No Python object is touched, so the
// interpreter lock is released for the whole call.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Load a float32 .bin and return element count (capped at max_floats).
// Returns -1 on IO error.
long load_f32_bin(const char* path, float* out, long max_floats) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long n = (long)fread(out, sizeof(float), (size_t)max_floats, f);
    fclose(f);
    return n;
}

// Radar sweep decode + Doppler compensation + frame transform.
//
// in:  raw (n, 8) float32 [x, y, z, v_r, power, motion_state, SNR, valid]
//      inv_s2e_rot: 3x3 row-major inverse sensor->ego rotation
//      s2l_rot: 3x3 row-major sensor->lidar rotation
//      s2l_trans: 3
//      ego_vel: 3 (ego frame)
// out: (n, 10) float32 [x, y, z, vx_comp, vy_comp, power, snr,
//      time_diff, vr_comp, radar_id] in the lidar frame.
void radar_compensate(const float* raw, long n,
                      const double* inv_s2e_rot,
                      const double* s2l_rot,
                      const double* s2l_trans,
                      const double* ego_vel,
                      double time_diff,
                      double radar_id,
                      float* out) {
    // Ego velocity decomposed into the sensor frame: v_s = v_e @ inv(R).T
    // (row vector times transpose == R_inv * v as column).
    double vs[3];
    for (int i = 0; i < 3; ++i) {
        vs[i] = inv_s2e_rot[i * 3 + 0] * ego_vel[0]
              + inv_s2e_rot[i * 3 + 1] * ego_vel[1]
              + inv_s2e_rot[i * 3 + 2] * ego_vel[2];
    }
    for (long k = 0; k < n; ++k) {
        const float* p = raw + k * 8;
        double x = p[0], y = p[1], z = p[2], vr = p[3];
        double r = std::sqrt(x * x + y * y + z * z);
        if (r < 1e-6) r = 1e-6;
        double az = std::atan2(y, x);
        double zr = z / r;
        if (zr > 1.0) zr = 1.0;
        if (zr < -1.0) zr = -1.0;
        double el = std::asin(zr);
        double ca = std::cos(az), sa = std::sin(az);
        double ce = std::cos(el), se = std::sin(el);

        double vr_comp = vs[0] * ca * ce + vs[1] * sa * ce + vs[2] * se + vr;
        double vx = vr_comp * ce * ca;
        double vy = vr_comp * ce * sa;

        // Rotate velocity (vx, vy, 0) and position into the lidar frame.
        double vel_l[2];
        vel_l[0] = s2l_rot[0] * vx + s2l_rot[1] * vy;
        vel_l[1] = s2l_rot[3] * vx + s2l_rot[4] * vy;

        double pos_l[3];
        for (int i = 0; i < 3; ++i) {
            pos_l[i] = s2l_rot[i * 3 + 0] * x + s2l_rot[i * 3 + 1] * y
                     + s2l_rot[i * 3 + 2] * z + s2l_trans[i];
        }

        float* o = out + k * 10;
        o[0] = (float)pos_l[0];
        o[1] = (float)pos_l[1];
        o[2] = (float)pos_l[2];
        o[3] = (float)vel_l[0];
        o[4] = (float)vel_l[1];
        o[5] = p[4];               // power
        o[6] = p[6];               // SNR
        o[7] = (float)time_diff;
        o[8] = (float)vr_comp;
        o[9] = (float)radar_id;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Greedy multi-class rotated-BEV NMS (the serving-pipeline host half).
//
// With tools.test --host-nms the model's device work ends at the top-k
// candidate decode (boxes + per-class scores); the O(N^2) IoU and the
// greedy suppression, sort-and-branch work, run here on the host
// (ops/nms_host.py; train/builder.py:make_predict_fn_generic).
// Semantics match ops/nms.py multiclass_nms_rotated (itself matching
// mmdet3d box3d_multiclass_nms, reference test_cfg use_rotate_nms):
// per class greedy by descending score, suppress rotated IoU > thr,
// merge survivors, keep top max_num by (score desc, class asc, idx asc)
// == flat top_k order over the class-major score matrix.
// ---------------------------------------------------------------------------

namespace {

struct Vec2 { double x, y; };

// Convex polygon area via the shoelace formula (CCW positive).
double poly_area(const Vec2* p, int n) {
    double a = 0.0;
    for (int i = 0; i < n; ++i) {
        int j = (i + 1) % n;
        a += p[i].x * p[j].y - p[j].x * p[i].y;
    }
    return 0.5 * a;
}

// Clip convex polygon `in` (n verts) by half-plane dot(nrm, p) <= c.
// Sutherland-Hodgman step; returns new vertex count (<= n + 1).
int clip_halfplane(const Vec2* in, int n, double nx, double ny, double c,
                   Vec2* out) {
    int m = 0;
    for (int i = 0; i < n; ++i) {
        const Vec2& a = in[i];
        const Vec2& b = in[(i + 1) % n];
        double da = nx * a.x + ny * a.y - c;
        double db = nx * b.x + ny * b.y - c;
        if (da <= 0) out[m++] = a;
        if ((da < 0 && db > 0) || (da > 0 && db < 0)) {
            double t = da / (da - db);
            out[m].x = a.x + t * (b.x - a.x);
            out[m].y = a.y + t * (b.y - a.y);
            ++m;
        }
    }
    return m;
}

// Exact rotated-BEV IoU of two boxes [x,y,z,w,l,h,yaw,...].
double rotated_iou(const float* b1, const float* b2) {
    double w1 = b1[3], l1 = b1[4], w2 = b2[3], l2 = b2[4];
    double a1 = w1 * l1, a2 = w2 * l2;
    if (a1 <= 0 || a2 <= 0) return 0.0;
    // Quick reject: circumscribed circles don't touch.
    double dx = (double)b1[0] - b2[0], dy = (double)b1[1] - b2[1];
    double r1 = 0.5 * std::sqrt(w1 * w1 + l1 * l1);
    double r2 = 0.5 * std::sqrt(w2 * w2 + l2 * l2);
    if (dx * dx + dy * dy > (r1 + r2) * (r1 + r2)) return 0.0;

    // Corners of box1 (CCW, matching ops/boxes3d.py bev_corners).
    double c = std::cos((double)b1[6]), s = std::sin((double)b1[6]);
    double hw = 0.5 * w1, hl = 0.5 * l1;
    const double lx[4] = {hw, -hw, -hw, hw};
    const double ly[4] = {hl, hl, -hl, -hl};
    Vec2 poly[16], tmp[16];
    for (int i = 0; i < 4; ++i) {
        poly[i].x = b1[0] + lx[i] * c - ly[i] * s;
        poly[i].y = b1[1] + lx[i] * s + ly[i] * c;
    }
    int n = 4;
    // Clip by box2's four half-planes (local-frame slabs).
    double c2 = std::cos((double)b2[6]), s2 = std::sin((double)b2[6]);
    double cx = b2[0], cy = b2[1];
    double hw2 = 0.5 * w2, hl2 = 0.5 * l2;
    // local u = (cos, sin), v = (-sin, cos); |dot(u, p-c)| <= hw2 etc.
    const double nxs[4] = {c2, -c2, -s2, s2};
    const double nys[4] = {s2, -s2, c2, -c2};
    const double cs[4] = {hw2 + c2 * cx + s2 * cy,
                          hw2 - c2 * cx - s2 * cy,
                          hl2 - s2 * cx + c2 * cy,
                          hl2 + s2 * cx - c2 * cy};
    for (int h = 0; h < 4 && n > 2; ++h) {
        n = clip_halfplane(poly, n, nxs[h], nys[h], cs[h], tmp);
        for (int i = 0; i < n; ++i) poly[i] = tmp[i];
    }
    if (n < 3) return 0.0;
    double inter = poly_area(poly, n);
    if (inter <= 0) return 0.0;
    if (inter > a1) inter = a1;
    if (inter > a2) inter = a2;
    return inter / (a1 + a2 - inter);
}

}  // namespace

extern "C" {

// boxes: (n, box_dim>=7) f32; scores: (n, c) f32.
// out_boxes: (max_num, box_dim); out_scores: (max_num,);
// out_labels: (max_num,) int32.  Returns the kept count (<= max_num).
long nms_rotated_multiclass(const float* boxes, const float* scores,
                            long n, long c, long box_dim,
                            double score_thr, double iou_thr, long max_num,
                            float* out_boxes, float* out_scores,
                            int* out_labels) {
    // Survivors across classes: (flat_rank_key, box_idx, class).
    struct Kept { float score; long cls; long idx; };
    Kept* kept = (Kept*)malloc(sizeof(Kept) * (size_t)(n * c > 0 ? n * c : 1));
    long n_kept = 0;

    long* order = (long*)malloc(sizeof(long) * (size_t)(n > 0 ? n : 1));
    long* alive = (long*)malloc(sizeof(long) * (size_t)(n > 0 ? n : 1));

    for (long cl = 0; cl < c; ++cl) {
        // Candidates above threshold, sorted by (score desc, idx asc).
        long m = 0;
        for (long i = 0; i < n; ++i)
            if (scores[i * c + cl] > score_thr) order[m++] = i;
        // Insertion sort by (score desc, idx asc): m <= nms_pre = 1000
        // and candidate lists are mostly ordered after the device top-k.
        for (long i = 1; i < m; ++i) {
            long key = order[i];
            float ks = scores[key * c + cl];
            long j = i - 1;
            while (j >= 0) {
                float js = scores[order[j] * c + cl];
                if (js > ks || (js == ks && order[j] < key)) break;
                order[j + 1] = order[j];
                --j;
            }
            order[j + 1] = key;
        }
        // Greedy suppression.
        long na = 0;
        for (long oi = 0; oi < m; ++oi) {
            long i = order[oi];
            const float* bi = boxes + i * box_dim;
            bool keep = true;
            for (long ai = 0; ai < na; ++ai) {
                const float* bk = boxes + alive[ai] * box_dim;
                if (rotated_iou(bk, bi) > iou_thr) { keep = false; break; }
            }
            if (keep) {
                alive[na++] = i;
                kept[n_kept].score = scores[i * c + cl];
                kept[n_kept].cls = cl;
                kept[n_kept].idx = i;
                ++n_kept;
            }
        }
    }

    // Merge: sort survivors by (score desc, class asc, idx asc) — the
    // flat top_k order over the class-major score matrix.
    for (long i = 1; i < n_kept; ++i) {
        Kept key = kept[i];
        long j = i - 1;
        while (j >= 0) {
            const Kept& kj = kept[j];
            bool before = kj.score > key.score
                || (kj.score == key.score
                    && (kj.cls < key.cls
                        || (kj.cls == key.cls && kj.idx < key.idx)));
            if (before) break;
            kept[j + 1] = kept[j];
            --j;
        }
        kept[j + 1] = key;
    }

    long out_n = n_kept < max_num ? n_kept : max_num;
    for (long i = 0; i < out_n; ++i) {
        memcpy(out_boxes + i * box_dim, boxes + kept[i].idx * box_dim,
               sizeof(float) * (size_t)box_dim);
        out_scores[i] = kept[i].score;
        out_labels[i] = (int)kept[i].cls;
    }
    for (long i = out_n; i < max_num; ++i) {
        memset(out_boxes + i * box_dim, 0, sizeof(float) * (size_t)box_dim);
        out_scores[i] = 0.0f;
        out_labels[i] = 0;
    }
    free(kept);
    free(order);
    free(alive);
    return out_n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Baseline JPEG entropy decode to DCT coefficients (the camera feed's host
// stage; data/jpeg.py).
//
// The first half of libjpeg's decode of a baseline sequential frame: the
// marker segments (SOI, DQT with 8- or 16-bit tables, DHT, SOF0 / SOF1,
// DRI, SOS; APPn and COM skipped) and the Huffman decode of every MCU of
// the one interleaved scan, as jdmarker.c and jdhuff.c run them: DC
// predictors reset at each restart marker, 0xFF00 stuffing, the fill bits
// at the end of a segment.  Each block's 64 coefficients are written as
// int16 in natural order (the zigzag undone with jpeg_natural_order), on
// its component's block grid padded to whole MCUs (mcus_x * H_c blocks a
// row, mcus_y * V_c rows), the layout libjpeg's coefficient buffer has.
// The quantisation tables go out in natural order too.  The IDCT, the
// upsampling and the colour conversion run on the card (kernels/
// jpeg_idct.py, kernels/rectify.py).
//
// What libjpeg would decode with a warning (a truncated segment, a bad
// Huffman code, a wrong restart marker, a coefficient index past 63,
// stray bytes before a marker) is an error here, and so is what the card's
// path does not take: a non-baseline frame (progressive, lossless,
// arithmetic), a precision other than 8 bits, a frame that is not three
// components, a scan that does not hold all three (non-interleaved), or a
// chroma sampling other than 4:4:4, 4:2:2 and 4:2:0 (4:2:x chroma planes at
// least three samples wide: libjpeg box-filters narrower ones).
//
// One call decodes a batch of bitstreams on std::threads, an image each
// at a time, straight into the caller's buffer; the output does not
// depend on the thread count.
// ---------------------------------------------------------------------------

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

const int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;
constexpr int kFastBits = 10;                // AC symbol and value together
constexpr int kErrLen = 256;                 // bytes of one image's message

struct HuffTable {
    bool defined = false;
    uint8_t look_len[1 << kLookBits];        // 0: longer than kLookBits
    uint8_t look_sym[1 << kLookBits];
    int32_t maxcode[18];                     // -1: no code of that length
    int32_t valoffset[18];
    uint8_t vals[256];
    // An AC code and its extra bits within kFastBits: the bits they take
    // (0: longer, or a DC table), the symbol, the coefficient.
    struct Fast {
        int16_t value;
        uint8_t len, symbol;
    } fast[1 << kFastBits];
};

struct Component {
    int id, h, v, tq;                        // sampling factors, DQT slot
    int td, ta;                              // DHT slots of the scan
};

struct Frame {
    int height = 0, width = 0, ncomp = 0, marker = 0, precision = 0;
    Component comp[4];
    int restart = 0;
    int32_t quant[4][64];
    bool quant_defined[4] = {false, false, false, false};
    HuffTable dc[4], ac[4];
    int scan_order[3];                       // frame component a scan slot
    const uint8_t* scan = nullptr;           // the entropy-coded data
    int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
    bool jfif = false, adobe = false;        // APP0 "JFIF", APP14 "Adobe"
    int adobe_transform = 0;
};

struct Error {
    char* msg;
    bool set = false;
    void operator()(const char* fmt, int a = 0, int b = 0) {
        if (!set) snprintf(msg, kErrLen, fmt, a, b);
        set = true;
    }
};

// jdhuff.c jpeg_make_d_derived_tbl: canonical codes from the counts.
bool build_huff(HuffTable& t, const uint8_t* bits, const uint8_t* vals,
                int nsym, bool dc) {
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; ++l)
        for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1 << si)) return false;
        code <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (bits[l - 1]) {
            t.valoffset[l] = p - huffcode[p];
            p += bits[l - 1];
            t.maxcode[l] = huffcode[p - 1];
        } else {
            t.maxcode[l] = -1;
        }
    }
    t.maxcode[17] = 0x7FFFFFFF;
    memset(t.look_len, 0, sizeof(t.look_len));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
        for (int i = 0; i < bits[l - 1]; ++i, ++p) {
            const int lo = huffcode[p] << (kLookBits - l);
            for (int k = 0; k < (1 << (kLookBits - l)); ++k) {
                t.look_len[lo + k] = static_cast<uint8_t>(l);
                t.look_sym[lo + k] = vals[p];
            }
        }
    }
    for (int i = 0; i < nsym; ++i) {
        if (dc && vals[i] > 15) return false;
        t.vals[i] = vals[i];
    }
    memset(t.fast, 0, sizeof(t.fast));
    p = 0;
    for (int l = 1; !dc && l <= kFastBits; ++l) {
        for (int i = 0; i < bits[l - 1]; ++i, ++p) {
            const int sym = vals[p], size = sym & 15;
            if (l + size > kFastBits) continue;
            const int lo = huffcode[p] << (kFastBits - l);
            for (int k = 0; k < (1 << (kFastBits - l)); ++k) {
                HuffTable::Fast& f = t.fast[lo + k];
                int v = 0;
                if (size) {                  // HUFF_EXTEND of the next bits
                    const int r = (k >> (kFastBits - l - size)) &
                                  ((1 << size) - 1);
                    v = r < (1 << (size - 1)) ? r - (1 << size) + 1 : r;
                }
                f.value = static_cast<int16_t>(v);
                f.len = static_cast<uint8_t>(l + size);
                f.symbol = static_cast<uint8_t>(sym);
            }
        }
    }
    t.defined = true;
    return true;
}

int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// Parse the marker segments from SOI to the first SOS.  Returns false
// (with a message) on what is refused.
bool parse_headers(const uint8_t* data, int64_t len, Frame& f, Error& err) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) {
        err("not a JPEG bitstream (no SOI marker)");
        return false;
    }
    const uint8_t* p = data + 2;
    const uint8_t* end = data + len;
    while (true) {
        if (p + 2 > end) {
            err("corrupt JPEG: the stream ends before a start of scan");
            return false;
        }
        if (p[0] != 0xFF) {
            err("corrupt JPEG: no marker at byte %d", (int)(p - data));
            return false;
        }
        const int marker = p[1];
        if (marker == 0xFF) {                // fill byte
            ++p;
            continue;
        }
        p += 2;
        if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) ||
            marker == 0x01) {
            continue;                        // no length
        }
        if (marker == 0xD9) {
            err("corrupt JPEG: end of image before a start of scan");
            return false;
        }
        if (p + 2 > end) {
            err("corrupt JPEG: truncated marker segment 0x%02X", marker);
            return false;
        }
        const int seg = u16(p);
        if (seg < 2 || p + seg > end) {
            err("corrupt JPEG: truncated marker segment 0x%02X", marker);
            return false;
        }
        const uint8_t* s = p + 2;
        const uint8_t* se = p + seg;
        p = se;
        if (marker == 0xDB) {                                     // DQT
            while (s < se) {
                const int pq = s[0] >> 4, tq = s[0] & 15;
                ++s;
                if (tq > 3 || pq > 1 || s + 64 * (pq + 1) > se) {
                    err("corrupt JPEG: bad DQT segment");
                    return false;
                }
                for (int k = 0; k < 64; ++k) {
                    f.quant[tq][kNaturalOrder[k]] = pq ? u16(s + 2 * k) : s[k];
                }
                s += 64 * (pq + 1);
                f.quant_defined[tq] = true;
            }
        } else if (marker == 0xC4) {                              // DHT
            while (s < se) {
                if (s + 17 > se) {
                    err("corrupt JPEG: bad DHT segment");
                    return false;
                }
                const int tc = s[0] >> 4, th = s[0] & 15;
                int nsym = 0;
                for (int l = 0; l < 16; ++l) nsym += s[1 + l];
                if (tc > 1 || th > 3 || nsym > 256 || s + 17 + nsym > se) {
                    err("corrupt JPEG: bad DHT segment");
                    return false;
                }
                HuffTable& t = tc ? f.ac[th] : f.dc[th];
                if (!build_huff(t, s + 1, s + 17, nsym, tc == 0)) {
                    err("corrupt JPEG: bad Huffman table");
                    return false;
                }
                s += 17 + nsym;
            }
        } else if (marker == 0xDD) {                              // DRI
            if (seg != 4) {
                err("corrupt JPEG: bad DRI segment");
                return false;
            }
            f.restart = u16(s);
        } else if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
                   marker != 0xC8 && marker != 0xCC) {            // SOFn
            if (f.marker) {
                err("corrupt JPEG: two start-of-frame segments");
                return false;
            }
            f.marker = marker;
            if (marker != 0xC0 && marker != 0xC1) {
                err("SOF marker 0x%02X (progressive or other non-baseline "
                    "coding) is not decoded on the card", marker);
                return false;
            }
            if (seg < 8) {
                err("corrupt JPEG: bad SOF segment");
                return false;
            }
            f.precision = s[0];
            f.height = u16(s + 1);
            f.width = u16(s + 3);
            f.ncomp = s[5];
            if (f.precision != 8) {
                err("%d-bit samples are not decoded on the card (8-bit are)",
                    f.precision);
                return false;
            }
            if (f.ncomp != 3) {
                err("%d components; the card decodes three-component (colour) "
                    "images", f.ncomp);
                return false;
            }
            if (seg != 8 + 3 * f.ncomp || f.width == 0) {
                err("corrupt JPEG: bad SOF segment");
                return false;
            }
            if (f.height == 0) {
                err("a frame whose height comes in a DNL marker is not "
                    "decoded on the card");
                return false;
            }
            for (int c = 0; c < 3; ++c) {
                Component& k = f.comp[c];
                k.id = s[6 + 3 * c];
                k.h = s[7 + 3 * c] >> 4;
                k.v = s[7 + 3 * c] & 15;
                k.tq = s[8 + 3 * c];
                if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) {
                    err("corrupt JPEG: bad SOF segment");
                    return false;
                }
            }
        } else if (marker == 0xE0) {                              // APP0
            f.jfif |= seg >= 16 && !memcmp(s, "JFIF", 5);
        } else if (marker == 0xEE) {                              // APP14
            if (seg >= 14 && !memcmp(s, "Adobe", 5)) {
                f.adobe = true;
                f.adobe_transform = s[11];
            }
        } else if (marker == 0xDA) {                              // SOS
            if (seg < 3) {
                err("corrupt JPEG: bad SOS segment");
                return false;
            }
            if (!f.marker) {
                err("corrupt JPEG: no start-of-frame segment");
                return false;
            }
            const int ns = s[0];
            if (ns != 3 || seg != 6 + 2 * ns) {
                err("a scan of %d components (non-interleaved) is not decoded "
                    "on the card", ns);
                return false;
            }
            for (int i = 0; i < ns; ++i) {
                const int id = s[1 + 2 * i], tables = s[2 + 2 * i];
                int c = 0;
                while (c < 3 && f.comp[c].id != id) ++c;
                for (int j = 0; j < i; ++j)
                    if (f.scan_order[j] == c) c = 3;
                if (c == 3) {
                    err("corrupt JPEG: bad SOS segment");
                    return false;
                }
                f.scan_order[i] = c;
                f.comp[c].td = tables >> 4;
                f.comp[c].ta = tables & 15;
                if (f.comp[c].td > 3 || f.comp[c].ta > 3 ||
                    !f.dc[f.comp[c].td].defined ||
                    !f.ac[f.comp[c].ta].defined) {
                    err("corrupt JPEG: a scan uses an undefined Huffman "
                        "table");
                    return false;
                }
                if (!f.quant_defined[f.comp[c].tq]) {
                    err("corrupt JPEG: a component uses an undefined "
                        "quantisation table");
                    return false;
                }
            }
            const uint8_t* q = s + 1 + 2 * ns;
            if (q[0] != 0 || q[1] != 63 || q[2] != 0) {
                err("corrupt JPEG: a sequential scan with spectral selection "
                    "or successive approximation");
                return false;
            }
            f.scan = se;
            break;
        } else if (marker == 0xDC) {
            err("a DNL marker is not decoded on the card");
            return false;
        }
        // APPn, COM and anything else: skipped.
    }
    const Component* c = f.comp;
    // jdapimin.c default_decompress_parms: how libjpeg tells RGB from YCbCr.
    const bool rgb =
        f.jfif ? false
        : f.adobe ? f.adobe_transform == 0
                  : c[0].id == 82 && c[1].id == 71 && c[2].id == 66;
    if (rgb) {
        err("an RGB-coded (not YCbCr) JPEG is not decoded on the card");
        return false;
    }
    if (c[1].h != c[2].h || c[1].v != c[2].v || c[0].h % c[1].h ||
        c[0].v % c[1].v) {
        err("chroma sampling is not decoded on the card (4:4:4, 4:2:2 and "
            "4:2:0 are)");
        return false;
    }
    const int rh = c[0].h / c[1].h, rv = c[0].v / c[1].v;
    if (!((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
          (rh == 2 && rv == 2))) {
        err("chroma sampling is not decoded on the card (4:4:4, 4:2:2 and "
            "4:2:0 are)");
        return false;
    }
    if (c[0].h * c[0].v + 2 * c[1].h * c[1].v > 10) {
        err("corrupt JPEG: more than 10 blocks an MCU");
        return false;
    }
    f.hmax = c[0].h;
    f.vmax = c[0].v;
    f.mcus_x = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
    f.mcus_y = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
    if (rh == 2 && (f.width + 1) / 2 < 3) {
        err("chroma planes narrower than three samples are box-filtered by "
            "libjpeg and not decoded on the card");
        return false;
    }
    return true;
}

// The entropy-coded segment's bits, as jdhuff.c's fill_bit_buffer reads
// them: 0xFF00 is a data byte 0xFF; at a marker (or the end of the data)
// zeros are fed, counted in `fake`, and consuming one of them is a
// truncated stream.
struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t acc = 0;
    int n = 0;                               // valid bits in acc (low end)
    int fake = 0;                            // of which fed zeros
    int marker = -1;                         // the marker read, -1 before one

    void fill() {
        if (marker < 0 && end - p >= 8) {    // 8 bytes, none 0xFF: at once
            uint64_t w;
            memcpy(&w, p, 8);
            w = __builtin_bswap64(w);
            const uint64_t x = ~w;
            if (!((x - 0x0101010101010101ull) & ~x & 0x8080808080808080ull)) {
                const int k = (64 - n) >> 3;
                acc = k == 8 ? w : (acc << (8 * k)) | (w >> (64 - 8 * k));
                p += k;
                n += 8 * k;
                return;
            }
        }
        while (n <= 56) {
            unsigned b = 0;
            if (marker < 0) {
                if (p >= end) {
                    marker = 0x100;          // end of data
                } else if (*p != 0xFF) {
                    b = *p++;
                } else {
                    const uint8_t* q = p + 1;
                    while (q < end && *q == 0xFF) ++q;
                    if (q < end && *q == 0x00) {
                        b = 0xFF;
                        p = q + 1;
                    } else {
                        marker = q < end ? *q : 0x100;
                        p = q < end ? q + 1 : end;
                    }
                }
            }
            if (marker >= 0) fake += 8;
            acc = (acc << 8) | b;
            n += 8;
        }
    }
    int peek(int k) const {
        return static_cast<int>((acc >> (n - k)) & ((1u << k) - 1));
    }
    int bits(int k) {
        const int v = peek(k);
        n -= k;
        return v;
    }
    bool truncated() const { return n < fake; }
    // -1 on a code no table entry has.
    int decode(const HuffTable& t) {
        if (n < 32) fill();
        const int look = peek(kLookBits);
        const int len = t.look_len[look];
        if (len) {
            n -= len;
            return t.look_sym[look];
        }
        const int code16 = peek(16);
        for (int l = kLookBits + 1; l <= 16; ++l) {
            const int code = code16 >> (16 - l);
            if (code <= t.maxcode[l]) {
                n -= l;
                return t.vals[code + t.valoffset[l]];
            }
        }
        return -1;
    }
    int extend(int s) {                      // HUFF_EXTEND of s bits
        if (s == 0) return 0;
        const int r = bits(s);
        return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
    }
    // At a restart point: drop the partial byte and read RSTn.
    bool restart(int expect) {
        if (n - fake >= 8) return false;    // stray bytes before the marker
        if (marker < 0) {
            if (p >= end || *p != 0xFF) return false;
            const uint8_t* q = p;
            while (q < end && *q == 0xFF) ++q;
            if (q >= end) return false;
            marker = *q;
            p = q + 1;
        }
        if (marker != 0xD0 + expect) return false;
        acc = 0;
        n = fake = 0;
        marker = -1;
        return true;
    }
};

bool decode_block(BitReader& br, const HuffTable& dc, const HuffTable& ac,
                  uint32_t& pred, int16_t* block, Error& err) {
    memset(block, 0, 64 * sizeof(int16_t));
    int s = br.decode(dc);
    if (s < 0) {
        err("corrupt JPEG: bad Huffman code");
        return false;
    }
    pred += static_cast<uint32_t>(br.extend(s));
    block[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; ++k) {
        if (br.n < 32) br.fill();
        const HuffTable::Fast& f = ac.fast[br.peek(kFastBits)];
        if (f.len) {
            br.n -= f.len;
            const int r = f.symbol >> 4;
            if (f.symbol & 15) {
                k += r;
                if (k > 63) {
                    err("corrupt JPEG: coefficient index past 63");
                    return false;
                }
                block[kNaturalOrder[k]] = f.value;
            } else {
                if (r != 15) break;
                k += 15;
            }
            continue;
        }
        const int rs = br.decode(ac);
        if (rs < 0) {
            err("corrupt JPEG: bad Huffman code");
            return false;
        }
        const int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) {
                err("corrupt JPEG: coefficient index past 63");
                return false;
            }
            block[kNaturalOrder[k]] = static_cast<int16_t>(br.extend(s));
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    if (br.truncated()) {
        err("corrupt JPEG: the entropy-coded data is truncated");
        return false;
    }
    return true;
}

bool decode_scan(const uint8_t* data, int64_t len, const Frame& f,
                 int16_t* const* out, Error& err) {
    BitReader br{f.scan, data + len};
    uint32_t pred[3] = {0, 0, 0};
    const int mcus = f.mcus_x * f.mcus_y;
    int next_rst = 0;
    for (int m = 0; m < mcus; ++m) {
        if (f.restart && m && m % f.restart == 0) {
            if (!br.restart(next_rst)) {
                err("corrupt JPEG: restart marker RST%d missing", next_rst);
                return false;
            }
            next_rst = (next_rst + 1) & 7;
            pred[0] = pred[1] = pred[2] = 0;
        }
        const int my = m / f.mcus_x, mx = m % f.mcus_x;
        for (int i = 0; i < 3; ++i) {
            const int c = f.scan_order[i];
            const Component& k = f.comp[c];
            const int bw = f.mcus_x * k.h;
            for (int v = 0; v < k.v; ++v) {
                for (int h = 0; h < k.h; ++h) {
                    const int64_t b = static_cast<int64_t>(my * k.v + v) * bw +
                                      mx * k.h + h;
                    if (!decode_block(br, f.dc[k.td], f.ac[k.ta], pred[c],
                                      out[c] + b * 64, err))
                        return false;
                }
            }
        }
    }
    return true;
}

}  // namespace

extern "C" {

// The frame geometry of n baseline JPEGs.  geom (n, 16) int32: height,
// width, SOF marker, components, then per component (Y, Cb, Cr) its block
// rows and columns (padded to whole MCUs) and libjpeg's downsampled
// height and width.  err (n, 256): each image's message, empty when it
// decodes.  Returns the number of images refused.
long jpeg_geometry(long n, const uint8_t* const* data, const int64_t* lengths,
                   int32_t* geom, char* err) {
    long bad = 0;
    for (long i = 0; i < n; ++i) {
        Frame f;
        Error e{err + i * kErrLen};
        err[i * kErrLen] = 0;
        int32_t* g = geom + i * 16;
        memset(g, 0, 16 * sizeof(int32_t));
        if (!parse_headers(data[i], lengths[i], f, e)) {
            ++bad;
            continue;
        }
        g[0] = f.height;
        g[1] = f.width;
        g[2] = f.marker;
        g[3] = f.ncomp;
        for (int c = 0; c < 3; ++c) {
            const Component& k = f.comp[c];
            g[4 + 4 * c] = f.mcus_y * k.v;
            g[5 + 4 * c] = f.mcus_x * k.h;
            g[6 + 4 * c] = (f.height * k.v + f.vmax - 1) / f.vmax;
            g[7 + 4 * c] = (f.width * k.h + f.hmax - 1) / f.hmax;
        }
    }
    return bad;
}

// Entropy-decode n baseline JPEGs on `threads` threads.  coefs: int16
// output; offsets (n, 3): where each component's blocks start in it, in
// int16 elements, laid out as jpeg_geometry's grid (block (r, c) at
// offset + (r * columns + c) * 64, natural order).  quant (n, 3, 64)
// int32: each component's quantisation table in natural order.  err as
// jpeg_geometry's.  Returns the number of images that failed.
long jpeg_decode_coefficients(long n, const uint8_t* const* data,
                              const int64_t* lengths, int16_t* coefs,
                              const int64_t* offsets, int32_t* quant,
                              long threads, char* err) {
    std::atomic<long> next{0}, bad{0};
    auto work = [&]() {
        for (long i = next++; i < n; i = next++) {
            Frame f;
            Error e{err + i * kErrLen};
            err[i * kErrLen] = 0;
            bool ok = parse_headers(data[i], lengths[i], f, e);
            if (ok) {
                int16_t* out[3];
                for (int c = 0; c < 3; ++c) {
                    out[c] = coefs + offsets[3 * i + c];
                    memcpy(quant + (3 * i + c) * 64, f.quant[f.comp[c].tq],
                           64 * sizeof(int32_t));
                }
                ok = decode_scan(data[i], lengths[i], f, out, e);
            }
            if (!ok) ++bad;
        }
    };
    const long t = threads < 1 ? 1 : (threads < n ? threads : n);
    std::vector<std::thread> pool;
    for (long k = 1; k < t; ++k) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
    return bad.load();
}

}  // extern "C"
