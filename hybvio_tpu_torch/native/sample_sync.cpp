// Native sample synchronization: the per-sample hot path of the host runtime.
//
// C++ implementation of the leader/follower/frame synchronizer with the same
// semantics as hybvio_tpu_torch/odometry/sample_sync.py (both follow the reference
// behavior, src/odometry/sample_sync.cpp): gyroscope samples lead, the
// nearest accelerometer sample follows, camera frames attach to their nearest
// leader and are re-matched as newer leaders arrive; ring buffers sized
// 100 + 5 * sampleSyncLag; out-of-order tolerant.
//
// Runs at IMU rate (200-800 Hz) on the input thread, so it is native like the
// reference's. Frames are referenced by integer handles; pixel data never
// crosses this layer. Exposed through a plain C ABI consumed via ctypes
// (hybvio_tpu_torch/io/native_sync.py).
//
// Build: the PyTorch port's copy of native/sample_sync.cpp, compiled with the other
// native sources of this directory into build/libhybvio_native.so by
// hybvio_tpu_torch/utils/native.py (g++ -O3 -march=native -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int LEADER_FILL_RATIO = 5;

struct Sample {
    double t = -1.0;
    double p[3] = {0, 0, 0};
};

struct Frame {
    double t = 0.0;
    int64_t handle = 0;  // opaque Python-side frame id
    int64_t num = 0;
    int leader_index = 0;
    double leader_time_diff = -1.0;
};

struct SampleSync {
    int size = 0;
    std::vector<Sample> sL, sF;
    std::vector<uint8_t> availableL;
    int countL = 0, countF = 0;
    int indexL = 0, indexF = 0;
    std::vector<Frame> frames;
    int64_t frame_count = 0;

    // parameters (reference: sampleSync* in parameter_definitions.c)
    int lag = 15;
    int frame_buffer_size = 10;
    int frame_count_required = 2;
    bool visual_update_enabled = true;
    double imu_to_camera_shift = 0.0;
    double variable_shift = 0.0;

    explicit SampleSync(int lag_, int frame_buffer, int frame_count_req,
                        bool visual_enabled, double shift)
        : lag(lag_), frame_buffer_size(frame_buffer),
          frame_count_required(frame_count_req),
          visual_update_enabled(visual_enabled), imu_to_camera_shift(shift) {
        size = 100 + LEADER_FILL_RATIO * lag;
        sL.assign(size, Sample{});
        sF.assign(size, Sample{});
        availableL.assign(size, 0);
    }

    void add_leader(double t, const double* p) {
        if (countL < size) {
            countL++;
        } else {
            // overwritten slot may have frames attached: drop them
            for (int i = (int)frames.size() - 1; i >= 0; --i) {
                if (frames[i].leader_index == indexL) {
                    frames.erase(frames.begin() + i);
                }
            }
        }
        sL[indexL].t = t;
        std::memcpy(sL[indexL].p, p, 3 * sizeof(double));
        for (auto& fr : frames) {
            double dti = std::fabs(t - fr.t);
            if (dti < fr.leader_time_diff) {
                fr.leader_index = indexL;
                fr.leader_time_diff = dti;
            }
        }
        availableL[indexL] = 1;
        indexL = (indexL + 1) % size;
    }

    void add_follower(double t, const double* p) {
        if (countF < size) countF++;
        sF[indexF].t = t;
        std::memcpy(sF[indexF].p, p, 3 * sizeof(double));
        indexF = (indexF + 1) % size;
    }

    // returns 1 if the frame was kept
    int add_frame(double t_in, int64_t handle) {
        double t = t_in - imu_to_camera_shift - variable_shift;
        if ((int)frames.size() >= frame_buffer_size) {
            // cull every 2nd (reference: cullBuffer)
            std::vector<Frame> kept;
            for (size_t i = 0; i < frames.size(); i += 2) kept.push_back(frames[i]);
            frames.swap(kept);
        }
        Frame fr;
        fr.t = t;
        fr.handle = handle;
        fr.num = ++frame_count;

        int best = -1;
        double best_dt = 0;
        for (int i = 0; i < size; ++i) {
            if (!availableL[i]) continue;
            double dti = std::fabs(sL[i].t - t);
            if (best < 0 || dti < best_dt) {
                best = i;
                best_dt = dti;
            }
        }
        if (best < 0) return 0;  // before any leader samples
        if (!frames.empty() && frames.back().t == t) return 0;  // duplicate
        fr.leader_index = best;
        fr.leader_time_diff = best_dt;
        frames.push_back(fr);
        return 1;
    }

    bool is_ready() const {
        return (!visual_update_enabled ||
                (int)frames.size() >= frame_count_required) &&
               countL >= lag && countF > 0;
    }

    // output struct filled by poll; returns 1 on success
    int poll(double* t, double* gyro, double* tF, double* acc,
             int64_t* frame_handle, int64_t* frame_num, double* frame_t) {
        if (!is_ready()) return 0;
        int idx = -1;
        double best_t = 0;
        for (int i = 0; i < size; ++i) {
            if (availableL[i] && (idx < 0 || sL[i].t < best_t)) {
                best_t = sL[i].t;
                idx = i;
            }
        }
        *t = sL[idx].t;
        std::memcpy(gyro, sL[idx].p, 3 * sizeof(double));
        sL[idx].t = -1;
        countL--;
        availableL[idx] = 0;

        int fbest = -1;
        double fdt = 0;
        for (int i = 0; i < countF; ++i) {
            double dti = std::fabs(sF[i].t - *t);
            if (fbest < 0 || dti < fdt) {
                fdt = dti;
                fbest = i;
            }
        }
        *tF = sF[fbest].t;
        std::memcpy(acc, sF[fbest].p, 3 * sizeof(double));

        *frame_handle = -1;
        *frame_num = -1;
        *frame_t = 0;
        for (int i = (int)frames.size() - 1; i >= 0; --i) {
            if (frames[i].leader_index == idx) {
                *frame_handle = frames[i].handle;
                *frame_num = frames[i].num;
                *frame_t = frames[i].t;
                frames.erase(frames.begin() + i);
            }
        }
        return 1;
    }
};

}  // namespace

extern "C" {

void* sample_sync_create(int lag, int frame_buffer, int frame_count_req,
                         int visual_enabled, double shift) {
    return new SampleSync(lag, frame_buffer, frame_count_req,
                          visual_enabled != 0, shift);
}

void sample_sync_destroy(void* h) { delete static_cast<SampleSync*>(h); }

void sample_sync_add_leader(void* h, double t, const double* p) {
    static_cast<SampleSync*>(h)->add_leader(t, p);
}

void sample_sync_add_follower(void* h, double t, const double* p) {
    static_cast<SampleSync*>(h)->add_follower(t, p);
}

int sample_sync_add_frame(void* h, double t, int64_t handle) {
    return static_cast<SampleSync*>(h)->add_frame(t, handle);
}

void sample_sync_set_time_shift(void* h, double shift) {
    static_cast<SampleSync*>(h)->variable_shift = shift;
}

int sample_sync_poll(void* h, double* t, double* gyro, double* tF, double* acc,
                     int64_t* frame_handle, int64_t* frame_num, double* frame_t) {
    return static_cast<SampleSync*>(h)->poll(t, gyro, tF, acc, frame_handle,
                                             frame_num, frame_t);
}

int sample_sync_frame_queue_size(void* h) {
    return (int)static_cast<SampleSync*>(h)->frames.size();
}

}  // extern "C"
