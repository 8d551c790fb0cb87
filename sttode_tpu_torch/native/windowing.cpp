// Native sliding-window trajectory preprocessor.
//
// C++ implementation of the ETH-UCY dataset windowing hot loop (reference
// utils/dataloader.py:77-181; identified as a real host-side hot path in
// SURVEY.md §3.4): per-file frame grouping, sliding windows of seq_len frames,
// full-coverage pedestrian filtering, 4-decimal rounding, traj_scale division,
// and the quadratic-fit non-linearity flag (poly_fit, dataloader.py:9-24).
//
// Exposed as a flat C ABI for ctypes (no binding library needed):
//   pass 1  ws_count(...)  -> number of scenes + total kept agents
//   pass 2  ws_fill(...)   -> trajectories, per-scene offsets, frames, flags
//
// Input rows are [frame, ped, x, y] doubles, in file order (any order works;
// rows are indexed by frame). Output trajectories are float32 [agent, seq, 2].
//
// Built at first use by sttode_tpu_torch/native/binding.py (g++ -O3 -shared
// -fPIC -std=c++17) into sttode_tpu_torch/_build/.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <map>
#include <vector>

namespace {

struct Indexed {
    std::vector<double> frames;              // sorted unique frames
    // per frame: list of (ped, x, y)
    std::vector<std::vector<std::array<double, 3>>> by_frame;
};

Indexed index_rows(const double* rows, int64_t n_rows) {
    std::map<double, std::vector<std::array<double, 3>>> grouped;
    for (int64_t i = 0; i < n_rows; ++i) {
        const double* r = rows + 4 * i;
        grouped[r[0]].push_back(std::array<double, 3>{{r[1], r[2], r[3]}});
    }
    Indexed out;
    out.frames.reserve(grouped.size());
    out.by_frame.reserve(grouped.size());
    for (auto& kv : grouped) {
        out.frames.push_back(kv.first);
        out.by_frame.push_back(std::move(kv.second));
    }
    return out;
}

inline double round4(double v) {
    // numpy.around semantics: round-half-even at 4 decimals
    double scaled = v * 10000.0;
    double r = std::nearbyint(scaled);
    // nearbyint honors the current rounding mode (to-nearest-even by default)
    return r / 10000.0;
}

// quadratic least-squares residual over the trailing pred_len points of one
// coordinate; mirrors np.polyfit(deg=2, full=True) residual.
double quad_residual(const double* t, const double* y, int n) {
    // normal equations for [t^2, t, 1]
    double s0 = n, s1 = 0, s2 = 0, s3 = 0, s4 = 0;
    double b0 = 0, b1 = 0, b2 = 0;
    for (int i = 0; i < n; ++i) {
        double ti = t[i], ti2 = ti * ti;
        s1 += ti; s2 += ti2; s3 += ti2 * ti; s4 += ti2 * ti2;
        b0 += y[i]; b1 += ti * y[i]; b2 += ti2 * y[i];
    }
    // solve A c = b, A = [[s4,s3,s2],[s3,s2,s1],[s2,s1,s0]]
    double A[3][3] = {{s4, s3, s2}, {s3, s2, s1}, {s2, s1, s0}};
    double b[3] = {b2, b1, b0};
    // gaussian elimination with partial pivoting
    for (int col = 0; col < 3; ++col) {
        int piv = col;
        for (int r = col + 1; r < 3; ++r)
            if (std::fabs(A[r][col]) > std::fabs(A[piv][col])) piv = r;
        std::swap(A[col], A[piv]);
        std::swap(b[col], b[piv]);
        if (std::fabs(A[col][col]) < 1e-12) return 0.0;
        for (int r = col + 1; r < 3; ++r) {
            double f = A[r][col] / A[col][col];
            for (int c2 = col; c2 < 3; ++c2) A[r][c2] -= f * A[col][c2];
            b[r] -= f * b[col];
        }
    }
    double c[3];
    for (int r = 2; r >= 0; --r) {
        double acc = b[r];
        for (int c2 = r + 1; c2 < 3; ++c2) acc -= A[r][c2] * c[c2];
        c[r] = acc / A[r][r];
    }
    double res = 0;
    for (int i = 0; i < n; ++i) {
        double fit = c[0] * t[i] * t[i] + c[1] * t[i] + c[2];
        double d = y[i] - fit;
        res += d * d;
    }
    return res;
}

struct SceneScratch {
    std::vector<float> traj;     // kept agents × seq_len × 2
    std::vector<double> ped_ids;
    std::vector<float> nonlin;
    double obs_boundary_frame;
};

// Core: enumerate windows, apply coverage filter. Template over "count only".
void process(const double* rows, int64_t n_rows, int obs_len, int pred_len,
             int skip, int min_ped, double traj_scale, double threshold,
             std::vector<SceneScratch>* scenes_out,
             int64_t* n_scenes, int64_t* total_agents) {
    Indexed idx = index_rows(rows, n_rows);
    const int seq_len = obs_len + pred_len;
    const int64_t n_frames = (int64_t)idx.frames.size();
    *n_scenes = 0;
    *total_agents = 0;

    std::vector<double> tgrid(pred_len);
    for (int i = 0; i < pred_len; ++i) tgrid[i] = i;

    for (int64_t start = 0; start + seq_len <= n_frames; start += skip) {
        // collect per-ped contiguous coverage within the window
        std::map<double, std::vector<std::array<double, 3>>> per_ped;
        for (int f = 0; f < seq_len; ++f) {
            double frame = idx.frames[start + f];
            for (auto& e : idx.by_frame[start + f]) {
                per_ped[e[0]].push_back(std::array<double, 3>{{frame, e[1], e[2]}});
            }
        }
        SceneScratch scratch;
        for (auto& kv : per_ped) {
            auto& entries = kv.second;
            // full contiguous coverage: EXACTLY one row per window frame
            // (span+count alone would accept a duplicated row paired with a
            // missing interior frame and emit a time-misaligned trajectory;
            // matches the python backend's exact per-frame check)
            if ((int64_t)entries.size() != seq_len) continue;
            bool exact = true;
            for (int i = 0; i < seq_len; ++i) {
                if (entries[i][0] != idx.frames[start + i]) {
                    exact = false;
                    break;
                }
            }
            if (!exact) continue;
            std::vector<double> xs(seq_len), ys(seq_len);
            for (int i = 0; i < seq_len; ++i) {
                xs[i] = round4(entries[i][1]) / traj_scale;
                ys[i] = round4(entries[i][2]) / traj_scale;
            }
            double res = quad_residual(tgrid.data(), xs.data() + obs_len,
                                       pred_len) +
                         quad_residual(tgrid.data(), ys.data() + obs_len,
                                       pred_len);
            scratch.nonlin.push_back(res >= threshold ? 1.0f : 0.0f);
            scratch.ped_ids.push_back(kv.first);
            for (int i = 0; i < seq_len; ++i) {
                scratch.traj.push_back((float)xs[i]);
                scratch.traj.push_back((float)ys[i]);
            }
        }
        int kept = (int)scratch.ped_ids.size();
        if (kept > min_ped) {
            scratch.obs_boundary_frame = idx.frames[start + obs_len];
            *n_scenes += 1;
            *total_agents += kept;
            if (scenes_out) scenes_out->push_back(std::move(scratch));
        }
    }
}

}  // namespace

extern "C" {

// Pass 1: sizes. Returns 0 on success.
int ws_count(const double* rows, int64_t n_rows, int obs_len, int pred_len,
             int skip, int min_ped, double traj_scale, double threshold,
             int64_t* out_n_scenes, int64_t* out_total_agents) {
    process(rows, n_rows, obs_len, pred_len, skip, min_ped, traj_scale,
            threshold, nullptr, out_n_scenes, out_total_agents);
    return 0;
}

// Pass 2: fill caller-allocated buffers.
//   traj_out       float32 [total_agents, seq_len, 2]
//   scene_offsets  int64   [n_scenes + 1] agent-prefix offsets
//   frames_out     double  [n_scenes] (frame at the obs/pred boundary)
//   ped_ids_out    double  [total_agents]
//   nonlin_out     float32 [total_agents]
int ws_fill(const double* rows, int64_t n_rows, int obs_len, int pred_len,
            int skip, int min_ped, double traj_scale, double threshold,
            float* traj_out, int64_t* scene_offsets, double* frames_out,
            double* ped_ids_out, float* nonlin_out) {
    std::vector<SceneScratch> scenes;
    int64_t n_scenes = 0, total_agents = 0;
    process(rows, n_rows, obs_len, pred_len, skip, min_ped, traj_scale,
            threshold, &scenes, &n_scenes, &total_agents);
    const int seq_len = obs_len + pred_len;
    int64_t agent_off = 0;
    scene_offsets[0] = 0;
    for (int64_t s = 0; s < n_scenes; ++s) {
        auto& sc = scenes[s];
        int64_t kept = (int64_t)sc.ped_ids.size();
        std::copy(sc.traj.begin(), sc.traj.end(),
                  traj_out + agent_off * seq_len * 2);
        std::copy(sc.ped_ids.begin(), sc.ped_ids.end(),
                  ped_ids_out + agent_off);
        std::copy(sc.nonlin.begin(), sc.nonlin.end(), nonlin_out + agent_off);
        frames_out[s] = sc.obs_boundary_frame;
        agent_off += kept;
        scene_offsets[s + 1] = agent_off;
    }
    return 0;
}

}  // extern "C"
