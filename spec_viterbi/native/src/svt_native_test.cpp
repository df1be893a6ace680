// Sanitizer test harness for the native data layer.
//
// The reference gates its C++ with Valgrind memcheck (run_tests.sh:4-12);
// this is the modern equivalent: parse a production-size model and a
// fixture sequence file — plus malformed inputs — under ASan/UBSan (see
// Makefile `asan` target, driven by scripts/check.sh, which writes the
// seeded corpus first). Usage: svt_native_asan_test <2405.chmm> <0_test_seq.ess>
// Exit code 0 = all checks passed.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {
void* svt_read_hmm(const char* path);
void svt_hmm_dims(void* handle, std::int64_t* dims4);
void svt_hmm_free(void* handle);
void* svt_read_ess(const char* path);
void svt_ess_dims(void* handle, std::int64_t* dims2);
void svt_ess_free(void* handle);
}

static int failures = 0;

#define CHECK(cond, msg)                                        \
    do {                                                        \
        if (!(cond)) {                                          \
            std::fprintf(stderr, "FAIL: %s\n", msg);            \
            ++failures;                                         \
        }                                                       \
    } while (0)

int main(int argc, char** argv) {
    if (argc != 3) {
        std::fprintf(stderr, "usage: %s <2405.chmm> <0_test_seq.ess>\n", argv[0]);
        return 2;
    }
    // production-size model: known dimensions (2405.chmm: 2407 states, 20
    // symbols, 9621 transitions — SURVEY.md §2.7)
    void* h = svt_read_hmm(argv[1]);
    CHECK(h != nullptr, "2405.chmm should parse");
    if (h) {
        std::int64_t d[4];
        svt_hmm_dims(h, d);
        CHECK(d[0] == 2407 && d[1] == 20 && d[2] == 9621 && d[3] == 1,
              "2405.chmm dimensions");
        svt_hmm_free(h);
    }

    // fixture sequences
    void* e = svt_read_ess(argv[2]);
    CHECK(e != nullptr, "0_test_seq.ess should parse");
    if (e) {
        std::int64_t d[2];
        svt_ess_dims(e, d);
        CHECK(d[0] == 2, "0_test_seq.ess sequence count");
        svt_ess_free(e);
    }

    // malformed inputs must return nullptr, never crash
    CHECK(svt_read_hmm("/nonexistent.chmm") == nullptr, "missing file");
    CHECK(svt_read_ess("/nonexistent.ess") == nullptr, "missing ess");
    CHECK(svt_read_hmm("/tmp/svt_hostile.chmm") == nullptr || true,
          "hostile parse ran");  // file written by check script

    if (failures == 0) std::puts("native sanitizer checks OK");
    return failures == 0 ? 0 : 1;
}
