// Run lengths of a flat column-major uint8 mask, starting with a 0-run: the
// counts of COCO's run-length encoding (what native/rle.cpp:rle_encode_counts
// computes), with a plain C entry point for ctypes. Host code: built with the
// host C++ compiler by ops/_build.py.
#include <cstdint>

// data: n >= 1 mask bytes (non-zero is foreground); runs: room for n + 1 counts.
// Returns the number of counts written.
extern "C" int64_t rle_counts(const uint8_t* data, int64_t n, int64_t* runs) {
  int64_t k = 0, run = 0;
  uint8_t cur = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t v = data[i] ? 1 : 0;
    if (v == cur) {
      ++run;
    } else {
      runs[k++] = run;
      cur = v;
      run = 1;
    }
  }
  runs[k++] = run;
  return k;
}
