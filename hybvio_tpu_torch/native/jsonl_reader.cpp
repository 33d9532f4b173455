// Native JSONL dataset reader: the bulk-input hot path of the host runtime.
//
// C++ equivalent of the reference's JSONL input parsing (reference:
// src/commandline/input_jsonl.cpp, which uses nlohmann-json): scans a
// data.jsonl file once and packs the high-rate sensor/frame events into
// flat arrays consumed zero-copy via ctypes (hybvio_tpu_torch/io/native_jsonl.py).
// Rare lines (groundTruth/ARKit/gps/... echoes, calibration objects) are
// returned as byte ranges so Python can json.loads just those lazily.
//
// The JSON subset parser below handles the full JSON grammar for one line
// (objects/arrays/strings/numbers/bools/null) with no allocation-heavy DOM:
// it walks the line once, extracting only the keys the input schema uses.
//
// Build: the PyTorch port's copy of native/jsonl_reader.cpp, compiled with the other
// native sources of this directory into build/libhybvio_native.so by
// hybvio_tpu_torch/utils/native.py (g++ -O3 -march=native -shared -fPIC).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ----- minimal single-line JSON cursor ------------------------------------

struct Cursor {
    const char* p;
    const char* end;

    void ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    }
    bool eat(char c) {
        ws();
        if (p < end && *p == c) { ++p; return true; }
        return false;
    }
    bool peek(char c) {
        ws();
        return p < end && *p == c;
    }
};

// skip a complete JSON value (any type); returns false on malformed input
bool skip_value(Cursor& c);

bool skip_string(Cursor& c) {
    if (!c.eat('"')) return false;
    while (c.p < c.end) {
        if (*c.p == '\\') { c.p += 2; continue; }
        if (*c.p == '"') { ++c.p; return true; }
        ++c.p;
    }
    return false;
}

bool skip_object(Cursor& c) {
    if (!c.eat('{')) return false;
    if (c.eat('}')) return true;
    do {
        if (!skip_string(c)) return false;
        if (!c.eat(':')) return false;
        if (!skip_value(c)) return false;
    } while (c.eat(','));
    return c.eat('}');
}

bool skip_array(Cursor& c) {
    if (!c.eat('[')) return false;
    if (c.eat(']')) return true;
    do {
        if (!skip_value(c)) return false;
    } while (c.eat(','));
    return c.eat(']');
}

bool skip_value(Cursor& c) {
    c.ws();
    if (c.p >= c.end) return false;
    switch (*c.p) {
        case '{': return skip_object(c);
        case '[': return skip_array(c);
        case '"': return skip_string(c);
        default:
            // number / true / false / null
            while (c.p < c.end && *c.p != ',' && *c.p != '}' && *c.p != ']' &&
                   *c.p != ' ' && *c.p != '\t' && *c.p != '\r')
                ++c.p;
            return true;
    }
}

bool parse_number(Cursor& c, double* out) {
    c.ws();
    char* endp = nullptr;
    double v = strtod(c.p, &endp);
    if (endp == c.p) return false;
    c.p = endp;
    *out = v;
    return true;
}

// parse a string into buf (no unescaping beyond \" — keys/values in this
// schema are plain identifiers)
bool parse_string(Cursor& c, std::string& out) {
    if (!c.eat('"')) return false;
    out.clear();
    while (c.p < c.end) {
        if (*c.p == '\\') { out.push_back(c.p[1]); c.p += 2; continue; }
        if (*c.p == '"') { ++c.p; return true; }
        out.push_back(*c.p++);
    }
    return false;
}

bool parse_number_array(Cursor& c, double* out, int max_n, int* n) {
    if (!c.eat('[')) return false;
    *n = 0;
    if (c.eat(']')) return true;
    do {
        double v;
        // nested arrays (row-major matrix form [[...],[...]]) flatten
        if (c.peek('[')) {
            int m = 0;
            if (!parse_number_array(c, out + *n, max_n - *n, &m)) return false;
            *n += m;
            continue;
        }
        if (!parse_number(c, &v)) return false;
        if (*n < max_n) out[(*n)++] = v;
    } while (c.eat(','));
    return c.eat(']');
}

// ----- packed event output --------------------------------------------------

enum Kind : int32_t {
    KIND_GYRO = 0,
    KIND_ACC = 1,
    KIND_FRAME = 2,
    KIND_ECHO = 3,   // values unused; line byte-range in echo arrays
};

struct PackedFrame {
    double t;
    double fx, fy, px, py;
    int32_t camera_ind;
    int32_t number;
};

struct Reader {
    // one row per event, parallel arrays
    std::vector<int32_t> kind;
    std::vector<double> time;
    std::vector<double> values;       // 3 per event (gyro/acc), zeros otherwise
    std::vector<int32_t> frame_begin; // index into frames[] (frame events), -1
    std::vector<int32_t> frame_count;
    std::vector<int64_t> line_off;    // byte offset of the source line
    std::vector<int64_t> line_len;
    std::vector<int32_t> frames_index; // "number" field of frame groups, -1

    std::vector<PackedFrame> frames;
    std::string error;
};

const char* find_key(const char* line, size_t len, const char* key) {
    // fast precheck: literal "key" occurrence (keys in this schema are unique
    // enough; full parse below confirms structure)
    std::string pat = std::string("\"") + key + "\"";
    const char* hit = static_cast<const char*>(
        memmem(line, len, pat.data(), pat.size()));
    return hit;
}

// parse one {"frames": [...]} group; returns false on malformed
bool parse_frame_group(Cursor c, Reader& r, double t_outer, int32_t number) {
    // c positioned at start of the frames array value
    if (!c.eat('[')) return false;
    int32_t begin = static_cast<int32_t>(r.frames.size());
    if (!c.eat(']')) {
        do {
            if (!c.eat('{')) return false;
            PackedFrame f{t_outer, -1.0, -1.0, -1.0, -1.0, 0, number};
            if (!c.eat('}')) {
                do {
                    std::string k;
                    if (!parse_string(c, k)) return false;
                    if (!c.eat(':')) return false;
                    if (k == "cameraInd") {
                        double v;
                        if (!parse_number(c, &v)) return false;
                        f.camera_ind = static_cast<int32_t>(v);
                    } else if (k == "time") {
                        if (!parse_number(c, &f.t)) return false;
                    } else if (k == "number") {
                        double v;
                        if (!parse_number(c, &v)) return false;
                        f.number = static_cast<int32_t>(v);
                    } else if (k == "cameraParameters") {
                        if (!c.eat('{')) return false;
                        if (!c.eat('}')) {
                            double focal = -1.0;
                            do {
                                std::string pk;
                                if (!parse_string(c, pk)) return false;
                                if (!c.eat(':')) return false;
                                if (pk == "focalLengthX") {
                                    if (!parse_number(c, &f.fx)) return false;
                                } else if (pk == "focalLengthY") {
                                    if (!parse_number(c, &f.fy)) return false;
                                } else if (pk == "focalLength") {
                                    if (!parse_number(c, &focal)) return false;
                                } else if (pk == "principalPointX") {
                                    if (!parse_number(c, &f.px)) return false;
                                } else if (pk == "principalPointY") {
                                    if (!parse_number(c, &f.py)) return false;
                                } else {
                                    if (!skip_value(c)) return false;
                                }
                            } while (c.eat(','));
                            if (!c.eat('}')) return false;
                            if ((f.fx <= 0 || f.fy <= 0) && focal > 0)
                                f.fx = f.fy = focal;
                        }
                    } else {
                        if (!skip_value(c)) return false;
                    }
                } while (c.eat(','));
                if (!c.eat('}')) return false;
            }
            r.frames.push_back(f);
        } while (c.eat(','));
        if (!c.eat(']')) return false;
    }
    int32_t count = static_cast<int32_t>(r.frames.size()) - begin;
    if (count == 0) return true;  // empty frames array -> no event
    // sort by camera_ind (insertion; count is 1-2 in practice)
    for (int i = begin + 1; i < begin + count; ++i)
        for (int j = i; j > begin && r.frames[j].camera_ind < r.frames[j - 1].camera_ind; --j)
            std::swap(r.frames[j], r.frames[j - 1]);

    r.kind.push_back(KIND_FRAME);
    r.time.push_back(r.frames[begin].t);
    r.values.insert(r.values.end(), {0.0, 0.0, 0.0});
    r.frame_begin.push_back(begin);
    r.frame_count.push_back(count);
    r.frames_index.push_back(number);
    return true;
}

const char* const ECHO_KEYS[] = {"groundTruth", "ARKit", "arengine", "arcore",
                                 "realsense", "gps", "rtkgps", "zed", "output",
                                 "model", "imuToCamera", "parameters"};

bool parse_line(const char* line, size_t len, int64_t off, Reader& r) {
    // classify by key presence, then structurally parse what we need
    if (find_key(line, len, "sensor")) {
        Cursor c{line, line + len};
        if (!c.eat('{')) return false;
        double t = 0.0;
        bool have_t = false;
        int sensor_kind = -1;
        double v[3] = {0, 0, 0};
        if (!c.eat('}')) {
            do {
                std::string k;
                if (!parse_string(c, k)) return false;
                if (!c.eat(':')) return false;
                if (k == "time") {
                    if (!parse_number(c, &t)) return false;
                    have_t = true;
                } else if (k == "sensor") {
                    if (!c.eat('{')) return false;
                    do {
                        std::string sk;
                        if (!parse_string(c, sk)) return false;
                        if (!c.eat(':')) return false;
                        if (sk == "type") {
                            std::string tv;
                            if (!parse_string(c, tv)) return false;
                            if (tv == "gyroscope") sensor_kind = KIND_GYRO;
                            else if (tv == "accelerometer") sensor_kind = KIND_ACC;
                        } else if (sk == "values") {
                            int n = 0;
                            if (!parse_number_array(c, v, 3, &n)) return false;
                        } else {
                            if (!skip_value(c)) return false;
                        }
                    } while (c.eat(','));
                    if (!c.eat('}')) return false;
                } else {
                    if (!skip_value(c)) return false;
                }
            } while (c.eat(','));
        }
        if (sensor_kind >= 0 && have_t) {
            r.kind.push_back(sensor_kind);
            r.time.push_back(t);
            r.values.insert(r.values.end(), {v[0], v[1], v[2]});
            r.frame_begin.push_back(-1);
            r.frame_count.push_back(0);
            r.frames_index.push_back(-1);
            r.line_off.push_back(off);
            r.line_len.push_back(static_cast<int64_t>(len));
        }
        return true;  // unknown sensor types are skipped like the reference
    }
    if (find_key(line, len, "frames")) {
        // outer walk for time/number, then delegate the frames array
        Cursor c{line, line + len};
        if (!c.eat('{')) return false;
        double t = 0.0;
        double number = -1.0;
        Cursor frames_at{nullptr, nullptr};
        if (!c.eat('}')) {
            do {
                std::string k;
                if (!parse_string(c, k)) return false;
                if (!c.eat(':')) return false;
                if (k == "time") {
                    if (!parse_number(c, &t)) return false;
                } else if (k == "number") {
                    if (!parse_number(c, &number)) return false;
                } else if (k == "frames") {
                    frames_at = c;
                    if (!skip_value(c)) return false;
                } else {
                    if (!skip_value(c)) return false;
                }
            } while (c.eat(','));
        }
        if (frames_at.p) {
            size_t before = r.kind.size();
            if (!parse_frame_group(frames_at, r, t,
                                   static_cast<int32_t>(number)))
                return false;
            if (r.kind.size() > before) {
                r.line_off.push_back(off);
                r.line_len.push_back(static_cast<int64_t>(len));
            }
        }
        return true;
    }
    for (const char* key : ECHO_KEYS) {
        if (find_key(line, len, key)) {
            // echo/calibration line: record the byte range; Python parses
            // these rare lines lazily with the full JSON parser
            Cursor c{line, line + len};
            double t = 0.0;
            const char* time_hit = find_key(line, len, "time");
            if (time_hit) {
                Cursor tc{time_hit + 6, line + len};  // past "time"
                while (tc.p < tc.end && (*tc.p == ' ' || *tc.p == ':')) ++tc.p;
                parse_number(tc, &t);
            }
            (void)c;
            r.kind.push_back(KIND_ECHO);
            r.time.push_back(t);
            r.values.insert(r.values.end(), {0.0, 0.0, 0.0});
            r.frame_begin.push_back(-1);
            r.frame_count.push_back(0);
            r.frames_index.push_back(-1);
            r.line_off.push_back(off);
            r.line_len.push_back(static_cast<int64_t>(len));
            return true;
        }
    }
    return true;  // unrecognized lines are ignored (reference behavior)
}

}  // namespace

extern "C" {

void* hyb_jsonl_open(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf;
    buf.resize(static_cast<size_t>(size));
    if (size > 0 && fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                        static_cast<size_t>(size)) {
        fclose(f);
        return nullptr;
    }
    fclose(f);

    Reader* r = new Reader();
    const char* data = buf.data();
    size_t n = buf.size();
    size_t start = 0;
    for (size_t i = 0; i <= n; ++i) {
        if (i == n || data[i] == '\n') {
            size_t len = i - start;
            // trim trailing \r and leading spaces
            while (len > 0 && (data[start + len - 1] == '\r')) --len;
            size_t s = start;
            while (len > 0 && (data[s] == ' ' || data[s] == '\t')) { ++s; --len; }
            if (len > 0) {
                if (!parse_line(data + s, len, static_cast<int64_t>(s), *r)) {
                    // malformed line: skip it (robustness over strictness;
                    // the Python fallback would raise instead)
                }
            }
            start = i + 1;
        }
    }
    return r;
}

int64_t hyb_jsonl_num_events(void* h) {
    return static_cast<int64_t>(static_cast<Reader*>(h)->kind.size());
}

int64_t hyb_jsonl_num_frames(void* h) {
    return static_cast<int64_t>(static_cast<Reader*>(h)->frames.size());
}

// copy packed event arrays into caller buffers (sized by num_events)
void hyb_jsonl_events(void* h, int32_t* kind, double* time, double* values,
                      int32_t* frame_begin, int32_t* frame_count,
                      int32_t* frames_index, int64_t* line_off,
                      int64_t* line_len) {
    Reader* r = static_cast<Reader*>(h);
    size_t n = r->kind.size();
    memcpy(kind, r->kind.data(), n * sizeof(int32_t));
    memcpy(time, r->time.data(), n * sizeof(double));
    memcpy(values, r->values.data(), n * 3 * sizeof(double));
    memcpy(frame_begin, r->frame_begin.data(), n * sizeof(int32_t));
    memcpy(frame_count, r->frame_count.data(), n * sizeof(int32_t));
    memcpy(frames_index, r->frames_index.data(), n * sizeof(int32_t));
    memcpy(line_off, r->line_off.data(), n * sizeof(int64_t));
    memcpy(line_len, r->line_len.data(), n * sizeof(int64_t));
}

// copy packed per-camera frame rows: t, fx, fy, px, py (doubles) and
// camera_ind, number (int32)
void hyb_jsonl_frames(void* h, double* tfxfypxpy, int32_t* camera_ind,
                      int32_t* number) {
    Reader* r = static_cast<Reader*>(h);
    size_t n = r->frames.size();
    for (size_t i = 0; i < n; ++i) {
        const PackedFrame& f = r->frames[i];
        tfxfypxpy[i * 5 + 0] = f.t;
        tfxfypxpy[i * 5 + 1] = f.fx;
        tfxfypxpy[i * 5 + 2] = f.fy;
        tfxfypxpy[i * 5 + 3] = f.px;
        tfxfypxpy[i * 5 + 4] = f.py;
        camera_ind[i] = f.camera_ind;
        number[i] = f.number;
    }
}

void hyb_jsonl_close(void* h) { delete static_cast<Reader*>(h); }

}  // extern "C"
