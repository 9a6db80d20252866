// Native radar sweep decode for omnihd_scenes_tpu_torch's host feed.
//
// The radar part of the JAX package's csrc/host_ops.cpp, copied function
// for function (load_f32_bin, radar_compensate), so a sweep decodes to
// the same rows bit for bit when both are built alike.  The
// hot per-sweep pipeline: load the .bin, ego-motion Doppler compensation,
// rotation into the lidar frame (parity with LoadRadarPointsMultiSweeps,
// reference loading.py:116-316).  The range crop, NMS and remap parts of
// the JAX package's library are not carried over: nothing in the port
// calls them yet.
//
// Built by data/native.py at first use: g++ -O3 -shared -fPIC.
// C ABI only; loaded via ctypes.  No Python object is touched, so the
// interpreter lock is released for the whole call.

#include <cmath>
#include <cstdio>

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
