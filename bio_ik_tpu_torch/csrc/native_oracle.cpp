// native_oracle — host-side C++ kernels for bio_ik_tpu_torch.
//
// The port's own copy of the JAX package's host library (the same code and
// the same g++ flags, so the two oracles agree bit for bit).  Built by
// bio_ik_tpu_torch/native.py with g++ on first use; no CUDA here:
//
//   * a scalar double-precision FK oracle over the compiled robot arrays
//     (counterpart of the reference's RobotFK_MoveIt trusted oracle,
//     reference: src/forward_kinematics.h:1468-1503) — used by tests and
//     host-side verification of device FK,
//   * batched oracle FK over many configurations,
//   * a convex support-point query (counterpart of the TouchGoal
//     support-vertex search, reference: src/goal_types.cpp:183-208).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
//
// Conventions match bio_ik_tpu_torch.robot.model: quaternions are xyzw;
// links are topologically indexed (parent[i] < i); joint types FIXED=0,
// REVOLUTE=1, PRISMATIC=2, FLOATING=3, PLANAR=4.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Quat { double x, y, z, w; };
struct Vec3 { double x, y, z; };

inline Quat qmul(const Quat& a, const Quat& b) {
    return {
        a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
        a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
        a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
        a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
    };
}

inline Vec3 qrot(const Quat& q, const Vec3& v) {
    // two-cross-product form
    const double tx = 2.0 * (q.y * v.z - q.z * v.y);
    const double ty = 2.0 * (q.z * v.x - q.x * v.z);
    const double tz = 2.0 * (q.x * v.y - q.y * v.x);
    return {
        v.x + q.w * tx + (q.y * tz - q.z * ty),
        v.y + q.w * ty + (q.z * tx - q.x * tz),
        v.z + q.w * tz + (q.x * ty - q.y * tx),
    };
}

inline Quat qaxis_angle(const Vec3& axis, double angle) {
    const double h = 0.5 * angle, s = std::sin(h);
    return {axis.x * s, axis.y * s, axis.z * s, std::cos(h)};
}

inline Quat qnormalize(const Quat& q) {
    const double n = std::sqrt(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w);
    const double f = n > 0 ? 1.0 / n : 0.0;
    return {q.x * f, q.y * f, q.z * f, q.w * f};
}

enum JointType : int64_t { FIXED = 0, REVOLUTE = 1, PRISMATIC = 2, FLOATING = 3, PLANAR = 4 };

}  // namespace

extern "C" {

// Forward kinematics over all links for one configuration.
//
//   nlinks             L
//   parent  (L,)       int64, parent[0] == -1
//   jtype   (L,)       int64
//   origin_pos (L,3)   double
//   origin_quat (L,4)  double xyzw
//   axis    (L,3)      double
//   vstart  (L,)       int64 (first variable index; -1 for fixed)
//   q       (V,)       double, mimic already applied by caller (or use
//                      bioik_apply_mimic below)
//   out_pos (L,3), out_quat (L,4)  outputs
void bioik_fk(
    int64_t nlinks, const int64_t* parent, const int64_t* jtype,
    const double* origin_pos, const double* origin_quat, const double* axis,
    const int64_t* vstart, const double* q,
    double* out_pos, double* out_quat) {
    for (int64_t i = 0; i < nlinks; i++) {
        if (parent[i] < 0) {
            out_pos[i * 3 + 0] = out_pos[i * 3 + 1] = out_pos[i * 3 + 2] = 0.0;
            out_quat[i * 4 + 0] = out_quat[i * 4 + 1] = out_quat[i * 4 + 2] = 0.0;
            out_quat[i * 4 + 3] = 1.0;
            continue;
        }
        const int64_t p = parent[i];
        const Vec3 ppos = {out_pos[p * 3], out_pos[p * 3 + 1], out_pos[p * 3 + 2]};
        const Quat prot = {out_quat[p * 4], out_quat[p * 4 + 1], out_quat[p * 4 + 2],
                           out_quat[p * 4 + 3]};
        const Vec3 opos = {origin_pos[i * 3], origin_pos[i * 3 + 1], origin_pos[i * 3 + 2]};
        const Quat oquat = {origin_quat[i * 4], origin_quat[i * 4 + 1],
                            origin_quat[i * 4 + 2], origin_quat[i * 4 + 3]};
        // pre = parent ∘ origin
        const Vec3 od = qrot(prot, opos);
        Vec3 pos = {ppos.x + od.x, ppos.y + od.y, ppos.z + od.z};
        Quat rot = qmul(prot, oquat);

        const Vec3 ax = {axis[i * 3], axis[i * 3 + 1], axis[i * 3 + 2]};
        const int64_t vs = vstart[i];
        switch (jtype[i]) {
            case REVOLUTE:
                rot = qmul(rot, qaxis_angle(ax, q[vs]));
                break;
            case PRISMATIC: {
                const Vec3 d = qrot(rot, {ax.x * q[vs], ax.y * q[vs], ax.z * q[vs]});
                pos = {pos.x + d.x, pos.y + d.y, pos.z + d.z};
                break;
            }
            case FLOATING: {
                const Vec3 d = qrot(rot, {q[vs], q[vs + 1], q[vs + 2]});
                pos = {pos.x + d.x, pos.y + d.y, pos.z + d.z};
                rot = qmul(rot, qnormalize({q[vs + 3], q[vs + 4], q[vs + 5], q[vs + 6]}));
                break;
            }
            case PLANAR: {
                const Vec3 d = qrot(rot, {q[vs], q[vs + 1], 0.0});
                pos = {pos.x + d.x, pos.y + d.y, pos.z + d.z};
                rot = qmul(rot, qaxis_angle({0, 0, 1}, q[vs + 2]));
                break;
            }
            default:
                break;  // FIXED
        }
        out_pos[i * 3 + 0] = pos.x;
        out_pos[i * 3 + 1] = pos.y;
        out_pos[i * 3 + 2] = pos.z;
        out_quat[i * 4 + 0] = rot.x;
        out_quat[i * 4 + 1] = rot.y;
        out_quat[i * 4 + 2] = rot.z;
        out_quat[i * 4 + 3] = rot.w;
    }
}

// Mimic propagation: q[i] = q[src[i]]·factor[i] + offset[i] where src[i] >= 0.
void bioik_apply_mimic(
    int64_t nvars, const int64_t* src, const double* factor,
    const double* offset, double* q) {
    for (int64_t i = 0; i < nvars; i++) {
        if (src[i] >= 0) q[i] = q[src[i]] * factor[i] + offset[i];
    }
}

// Batched FK over B configurations, emitting only the requested tip links.
void bioik_fk_batch(
    int64_t nlinks, const int64_t* parent, const int64_t* jtype,
    const double* origin_pos, const double* origin_quat, const double* axis,
    const int64_t* vstart,
    int64_t nvars, const int64_t* mimic_src, const double* mimic_factor,
    const double* mimic_offset,
    int64_t batch, const double* qs,
    int64_t ntips, const int64_t* tip_links,
    double* out_pos /* (B, T, 3) */, double* out_quat /* (B, T, 4) */) {
    double* lp = new double[nlinks * 3];
    double* lq = new double[nlinks * 4];
    double* qbuf = new double[nvars];
    for (int64_t b = 0; b < batch; b++) {
        std::memcpy(qbuf, qs + b * nvars, nvars * sizeof(double));
        bioik_apply_mimic(nvars, mimic_src, mimic_factor, mimic_offset, qbuf);
        bioik_fk(nlinks, parent, jtype, origin_pos, origin_quat, axis, vstart,
                 qbuf, lp, lq);
        for (int64_t t = 0; t < ntips; t++) {
            const int64_t li = tip_links[t];
            std::memcpy(out_pos + (b * ntips + t) * 3, lp + li * 3, 3 * sizeof(double));
            std::memcpy(out_quat + (b * ntips + t) * 4, lq + li * 4, 4 * sizeof(double));
        }
    }
    delete[] lp;
    delete[] lq;
    delete[] qbuf;
}

// Convex support point: index of the point maximizing dot(p, dir).
// Counterpart of the reference's edge-walk support search
// (goal_types.cpp:183-208) — exact max over the point set.
int64_t bioik_support_point(
    int64_t npoints, const double* points, const double* dir) {
    int64_t best = 0;
    double best_d = -1e300;
    for (int64_t i = 0; i < npoints; i++) {
        const double d = points[i * 3] * dir[0] + points[i * 3 + 1] * dir[1] +
                         points[i * 3 + 2] * dir[2];
        if (d > best_d) {
            best_d = d;
            best = i;
        }
    }
    return best;
}

int bioik_native_abi_version() { return 1; }

}  // extern "C"
