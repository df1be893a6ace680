// Native data layer for spec_viterbi: .chmm / .ess parsers.
//
// Counterpart of the reference's C++ data reader
// (Viterbi_impl/data_reader.cpp): same formats, same −log2 conversion at
// load (data_reader.cpp:41,54,71), emissions transposed to [symbol][state]
// (data_reader.cpp:49-57), and the .ess sequence-numbering validation
// (data_reader.cpp:111-119). Re-designed rather than ported: one
// NUL-terminated buffer with a branch-light float scanner instead of iostream operator>>,
// exposed through a flat C ABI consumed via ctypes (no pybind11 in the
// image). A parse error returns nullptr and the Python fallback re-parses
// to raise a precise exception.
//
// Build: make -C spec_viterbi/native/src  (or the lazy auto-build in
// loader.py).

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

// Modified probability: −log2(p) for p > 0, else +inf (HMM.h:51-57).
inline float to_mod_prob(double p) {
    return p > 0.0 ? static_cast<float>(-std::log2(p)) : kInf;
}

struct Scanner {
    const char* p;
    const char* end;
    bool ok = true;

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r')) ++p;
    }

    bool next_double(double* out) {
        skip_ws();
        if (p >= end) { ok = false; return false; }
        char* after = nullptr;
        errno = 0;
        double v = std::strtod(p, &after);
        if (after == p || errno == ERANGE) { ok = false; return false; }
        p = after;
        *out = v;
        return true;
    }

    bool next_i64(std::int64_t* out) {
        skip_ws();
        if (p >= end) { ok = false; return false; }
        char* after = nullptr;
        errno = 0;
        long long v = std::strtoll(p, &after, 10);
        if (after == p || errno == ERANGE) { ok = false; return false; }
        p = after;
        *out = v;
        return true;
    }
};

// Reads the whole file into a NUL-terminated buffer. strtod/strtoll need a
// terminator; a raw mmap would let them scan past the mapping when the last
// token ends exactly at a page boundary.
struct MappedFile {
    std::string buf;

    bool open_file(const char* path) {
        int fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (::fstat(fd, &st) != 0 || st.st_size == 0) {
            ::close(fd);
            return false;
        }
        buf.resize(static_cast<std::size_t>(st.st_size));
        std::size_t off = 0;
        while (off < buf.size()) {
            ssize_t got = ::read(fd, buf.data() + off, buf.size() - off);
            if (got <= 0) {
                ::close(fd);
                return false;
            }
            off += static_cast<std::size_t>(got);
        }
        ::close(fd);
        return true;
    }

    const char* data() const { return buf.c_str(); }  // NUL-terminated
    std::size_t size() const { return buf.size(); }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- .chmm --

struct SvtHmm {
    std::int64_t states_num = 0;
    std::int64_t emit_num = 0;
    std::vector<std::int64_t> trans_rows, trans_cols;
    std::vector<float> trans_probs;
    std::vector<float> emissions;  // [emit_num * states_num], symbol-major
    std::vector<std::int64_t> start_cols;
    std::vector<float> start_probs;
};

// Largest accepted header count: bounds allocations from untrusted files
// (and keeps e*n far from int64 overflow). The corpus tops out ~10^4.
constexpr std::int64_t kMaxCount = 100'000'000;

static void* svt_read_hmm_impl(const char* path) {
    MappedFile f;
    if (!f.open_file(path)) return nullptr;
    Scanner sc{f.data(), f.data() + f.size()};

    auto hmm = new SvtHmm();
    std::int64_t n = 0, s = 0, e = 0, t = 0;
    if (!sc.next_i64(&n) || n < 0 || n > kMaxCount) { delete hmm; return nullptr; }
    hmm->states_num = n;

    if (!sc.next_i64(&s) || s < 0 || s > kMaxCount) { delete hmm; return nullptr; }
    hmm->start_cols.resize(s);
    hmm->start_probs.resize(s);
    for (std::int64_t i = 0; i < s; ++i) {
        double prob;
        if (!sc.next_i64(&hmm->start_cols[i]) || !sc.next_double(&prob) ||
            hmm->start_cols[i] < 0 || hmm->start_cols[i] >= n) {
            delete hmm; return nullptr;
        }
        hmm->start_probs[i] = to_mod_prob(prob);
    }

    if (!sc.next_i64(&e) || e < 0 || e > kMaxCount / (n ? n : 1)) { delete hmm; return nullptr; }
    hmm->emit_num = e;
    // file layout is [state][symbol]; store transposed [symbol][state]
    hmm->emissions.assign(static_cast<std::size_t>(e * n), kInf);
    for (std::int64_t state = 0; state < n; ++state) {
        for (std::int64_t sym = 0; sym < e; ++sym) {
            double prob;
            if (!sc.next_double(&prob)) { delete hmm; return nullptr; }
            hmm->emissions[static_cast<std::size_t>(sym * n + state)] =
                to_mod_prob(prob);
        }
    }

    if (!sc.next_i64(&t) || t < 0 || t > kMaxCount) { delete hmm; return nullptr; }
    hmm->trans_rows.resize(t);
    hmm->trans_cols.resize(t);
    hmm->trans_probs.resize(t);
    for (std::int64_t i = 0; i < t; ++i) {
        double prob;
        if (!sc.next_i64(&hmm->trans_rows[i]) ||
            !sc.next_i64(&hmm->trans_cols[i]) || !sc.next_double(&prob) ||
            hmm->trans_rows[i] < 0 || hmm->trans_rows[i] >= n ||
            hmm->trans_cols[i] < 0 || hmm->trans_cols[i] >= n) {
            delete hmm; return nullptr;
        }
        hmm->trans_probs[i] = to_mod_prob(prob);
    }
    return hmm;
}

void* svt_read_hmm(const char* path) {
    // extern "C" boundary: exceptions (e.g. bad_alloc on a hostile file)
    // must become the documented nullptr, not std::terminate
    try {
        return svt_read_hmm_impl(path);
    } catch (...) {
        return nullptr;
    }
}

void svt_hmm_dims(void* handle, std::int64_t* dims4) {
    auto* hmm = static_cast<SvtHmm*>(handle);
    dims4[0] = hmm->states_num;
    dims4[1] = hmm->emit_num;
    dims4[2] = static_cast<std::int64_t>(hmm->trans_rows.size());
    dims4[3] = static_cast<std::int64_t>(hmm->start_cols.size());
}

void svt_hmm_fill(void* handle, std::int64_t* trans_rows,
                  std::int64_t* trans_cols, float* trans_probs,
                  float* emissions, std::int64_t* start_cols,
                  float* start_probs) {
    auto* hmm = static_cast<SvtHmm*>(handle);
    auto copy = [](auto& vec, auto* dst) {
        if (!vec.empty())
            std::memcpy(dst, vec.data(), vec.size() * sizeof(vec[0]));
    };
    copy(hmm->trans_rows, trans_rows);
    copy(hmm->trans_cols, trans_cols);
    copy(hmm->trans_probs, trans_probs);
    copy(hmm->emissions, emissions);
    copy(hmm->start_cols, start_cols);
    copy(hmm->start_probs, start_probs);
}

void svt_hmm_free(void* handle) { delete static_cast<SvtHmm*>(handle); }

// ----------------------------------------------------------------- .ess --

struct SvtEss {
    std::vector<std::int64_t> lengths;
    std::vector<std::int32_t> flat;
};

static void* svt_read_ess_impl(const char* path) {
    MappedFile f;
    if (!f.open_file(path)) return nullptr;
    Scanner sc{f.data(), f.data() + f.size()};

    auto ess = new SvtEss();
    std::int64_t count = 0;
    if (!sc.next_i64(&count) || count < 0 || count > kMaxCount) { delete ess; return nullptr; }
    ess->lengths.reserve(count);
    for (std::int64_t i = 0; i < count; ++i) {
        std::int64_t idx = 0, len = 0;
        // sequence numbering must be 0..N-1 in order (data_reader.cpp:111-119)
        if (!sc.next_i64(&idx) || idx != i || !sc.next_i64(&len) || len < 0 ||
            len > kMaxCount) {
            delete ess; return nullptr;
        }
        ess->lengths.push_back(len);
        for (std::int64_t k = 0; k < len; ++k) {
            std::int64_t sym;
            if (!sc.next_i64(&sym)) { delete ess; return nullptr; }
            ess->flat.push_back(static_cast<std::int32_t>(sym));
        }
    }
    return ess;
}

void* svt_read_ess(const char* path) {
    try {
        return svt_read_ess_impl(path);
    } catch (...) {
        return nullptr;
    }
}

void svt_ess_dims(void* handle, std::int64_t* dims2) {
    auto* ess = static_cast<SvtEss*>(handle);
    dims2[0] = static_cast<std::int64_t>(ess->lengths.size());
    dims2[1] = static_cast<std::int64_t>(ess->flat.size());
}

void svt_ess_lengths(void* handle, std::int64_t* out) {
    auto* ess = static_cast<SvtEss*>(handle);
    if (!ess->lengths.empty())
        std::memcpy(out, ess->lengths.data(),
                    ess->lengths.size() * sizeof(std::int64_t));
}

void svt_ess_fill(void* handle, std::int32_t* out) {
    auto* ess = static_cast<SvtEss*>(handle);
    if (!ess->flat.empty())
        std::memcpy(out, ess->flat.data(),
                    ess->flat.size() * sizeof(std::int32_t));
}

void svt_ess_free(void* handle) { delete static_cast<SvtEss*>(handle); }

}  // extern "C"
