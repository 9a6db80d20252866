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
