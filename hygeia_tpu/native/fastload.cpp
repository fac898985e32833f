// Fast gzip CSV count-matrix loader.
//
// The reference pipeline moves all data between stages as gzip-compressed
// comma-separated count matrices (positions_{chrom}.txt.gz etc.), parsed
// with pandas.read_table — which for a 1e6-row chromosome costs seconds of
// single-threaded Python per file and dominates task startup (the reference
// pays this once per (chrom, batch, seed) INFER task).
//
// This native loader inflates with zlib and parses integers/floats with a
// tight branch-light scanner, multi-threaded across row ranges after an
// initial newline scan. Exposed to Python via ctypes (hygeia_tpu/native/
// loader.py); no pybind11 dependency.
//
// Build: see build.sh (g++ -O3 -shared -fPIC fastload.cpp -lz -lpthread).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Inflate a whole .gz (or plain) file into memory.
bool read_all(const char* path, std::string* out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  gzbuffer(f, 1 << 20);
  char buf[1 << 20];
  int n;
  while ((n = gzread(f, buf, sizeof(buf))) > 0) {
    out->append(buf, static_cast<size_t>(n));
  }
  bool ok = (n == 0);
  gzclose(f);
  return ok;
}

// Parse one number starting at p; advances p past the token.
inline double parse_number(const char*& p, const char* end) {
  // Fast path: plain integers (the overwhelming majority of count data).
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  int64_t ival = 0;
  const char* digits_start = p;
  while (p < end && *p >= '0' && *p <= '9') {
    ival = ival * 10 + (*p - '0');
    ++p;
  }
  if (p < end && (*p == '.' || *p == 'e' || *p == 'E')) {
    // Fall back to strtod for decimals/exponents ("3.0" from np.savetxt).
    char* q = nullptr;
    double v = strtod(digits_start - (neg ? 1 : 0), &q);
    p = q;
    return v;
  }
  return neg ? -static_cast<double>(ival) : static_cast<double>(ival);
}

void parse_rows(const char* data, const int64_t* offsets, int64_t row_begin,
                int64_t row_end, int64_t n_cols, double* out) {
  for (int64_t r = row_begin; r < row_end; ++r) {
    const char* p = data + offsets[r];
    const char* end = data + offsets[r + 1];
    double* row = out + r * n_cols;
    for (int64_t c = 0; c < n_cols; ++c) {
      while (p < end && (*p == ',' || *p == ' ' || *p == '\t')) ++p;
      row[c] = (p < end) ? parse_number(p, end) : 0.0;
    }
  }
}

}  // namespace

extern "C" {

// First pass: returns rows/cols so the caller can allocate the output.
// Returns 0 on success; fills *n_rows, *n_cols. The inflated buffer is kept
// in a handle for the second pass.
struct LoadHandle {
  std::string data;
  std::vector<int64_t> offsets;  // n_rows + 1 entries, byte offset per line
  int64_t n_cols = 0;
};

void* fastload_open_ex(const char* path, int64_t skip_rows, int64_t* n_rows,
                       int64_t* n_cols) {
  auto* h = new LoadHandle();
  if (!read_all(path, &h->data)) {
    delete h;
    return nullptr;
  }
  const char* p = h->data.data();
  const char* end = p + h->data.size();
  h->offsets.push_back(0);
  for (const char* q = p; q < end; ++q) {
    if (*q == '\n') h->offsets.push_back(q - p + 1);
  }
  if (h->offsets.back() != static_cast<int64_t>(h->data.size())) {
    h->offsets.push_back(h->data.size());  // file without trailing newline
  }
  // Skip header lines (aggregate-stage tables carry one). Skipping at or
  // past the last line leaves ZERO data rows (never the header parsed as
  // data), and the column scan below is guarded for the empty case.
  if (skip_rows > 0) {
    int64_t drop = std::min(
        skip_rows, static_cast<int64_t>(h->offsets.size()) - 1);
    h->offsets.erase(h->offsets.begin(), h->offsets.begin() + drop);
  }
  int64_t rows = static_cast<int64_t>(h->offsets.size()) - 1;
  // Drop trailing empty line(s).
  while (rows > 0 && h->offsets[rows] - h->offsets[rows - 1] <= 1) --rows;
  // Column count from the first data row: comma OR tab separated.
  int64_t cols = 0;
  if (rows > 0) {
    cols = 1;
    for (int64_t i = h->offsets[0]; i < h->offsets[1]; ++i) {
      if (h->data[i] == ',' || h->data[i] == '\t') ++cols;
    }
  }
  h->n_cols = cols;
  *n_rows = rows;
  *n_cols = cols;
  return h;
}

void* fastload_open(const char* path, int64_t* n_rows, int64_t* n_cols) {
  return fastload_open_ex(path, 0, n_rows, n_cols);
}

// Second pass: parse into caller-allocated (n_rows, n_cols) float64 buffer.
int fastload_parse(void* handle, double* out, int64_t n_rows, int n_threads) {
  auto* h = static_cast<LoadHandle*>(handle);
  if (!h) return 1;
  if (n_threads < 1) n_threads = 1;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  std::vector<std::thread> workers;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n_rows, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(parse_rows, h->data.data(), h->offsets.data(), lo, hi,
                         h->n_cols, out);
  }
  for (auto& w : workers) w.join();
  return 0;
}

void fastload_close(void* handle) { delete static_cast<LoadHandle*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Fast gzip CSV table WRITER (the aggregate stage's counterpart of the
// loader above). pandas' to_csv formats every int through its Python-object
// CSV path (~20 s for the nine ~400k x 51 per-chromosome tables at
// production scale, profiled round 5); this writer formats rows with a
// tight itoa and deflates per-thread row ranges as INDEPENDENT gzip
// members (concatenated members are a valid gzip stream per RFC 1952 —
// Python's gzip module and pandas read them transparently), so both the
// formatting and the compression parallelise. Decompressed bytes are
// identical to pandas' to_csv output for integer tables (asserted by
// tests/test_pipeline.py::test_fastwrite_matches_pandas_to_csv).
// ---------------------------------------------------------------------------

namespace {

inline char* write_int(char* p, int64_t v) {
  if (v < 0) {
    *p++ = '-';
    v = -v;
  }
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + (v % 10));
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

// Deflate `raw` as one complete gzip member.
std::string gzip_member(const std::string& raw, int level) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8, Z_DEFAULT_STRATEGY) !=
      Z_OK) {
    return std::string();
  }
  std::string out;
  out.resize(deflateBound(&zs, raw.size()) + 64);
  zs.next_in = reinterpret_cast<Bytef*>(const_cast<char*>(raw.data()));
  zs.avail_in = static_cast<uInt>(raw.size());
  zs.next_out = reinterpret_cast<Bytef*>(&out[0]);
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = deflate(&zs, Z_FINISH);
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return std::string();
  out.resize(zs.total_out);
  return out;
}

void format_rows(const int64_t* index, const int64_t* data, int64_t n_cols,
                 int64_t row_begin, int64_t row_end, char sep, int level,
                 std::string* out_member) {
  std::string raw;
  raw.reserve(static_cast<size_t>(row_end - row_begin) * (n_cols + 1) * 8);
  std::vector<char> line((n_cols + 2) * 21 + 2);
  for (int64_t r = row_begin; r < row_end; ++r) {
    char* p = line.data();
    if (index) {
      p = write_int(p, index[r]);
      *p++ = sep;
    }
    const int64_t* row = data + r * n_cols;
    for (int64_t c = 0; c < n_cols; ++c) {
      if (c) *p++ = sep;
      p = write_int(p, row[c]);
    }
    *p++ = '\n';
    raw.append(line.data(), static_cast<size_t>(p - line.data()));
  }
  *out_member = gzip_member(raw, level);  // empty = deflate failure
}

}  // namespace

namespace {

void format_rows_f(const int64_t* index, const double* data, int64_t n_cols,
                   int64_t row_begin, int64_t row_end, char sep, int level,
                   int sig_digits, std::string* out_member) {
  std::string raw;
  raw.reserve(static_cast<size_t>(row_end - row_begin) * (n_cols + 1) * 12);
  std::vector<char> line((n_cols + 2) * 32 + 2);
  for (int64_t r = row_begin; r < row_end; ++r) {
    char* p = line.data();
    if (index) {
      p = write_int(p, index[r]);
      *p++ = sep;
    }
    const double* row = data + r * n_cols;
    for (int64_t c = 0; c < n_cols; ++c) {
      if (c) *p++ = sep;
      double v = row[c];
      // Range test first: casting NaN, inf or a value outside int64 to
      // int64 is undefined behaviour.
      if (v > -1e15 && v < 1e15 &&
          v == static_cast<double>(static_cast<int64_t>(v))) {
        // Integral values print without a decimal point, then ".0" —
        // matching repr(float) for integral floats ("1.0", "0.0").
        p = write_int(p, static_cast<int64_t>(v));
        *p++ = '.';
        *p++ = '0';
      } else {
        p += std::snprintf(p, 32, "%.*g", sig_digits, v);
      }
    }
    *p++ = '\n';
    raw.append(line.data(), static_cast<size_t>(p - line.data()));
  }
  *out_member = gzip_member(raw, level);
}

// Shared fan-out: format per-thread row ranges with `fmt` into independent
// gzip members (header first), verify, and write the file. Both the int
// and float writers delegate here (a previous revision duplicated the
// ~40-line body; round-5 review finding).
template <typename Fmt>
int write_table_members(const char* path, const char* header, int64_t n_rows,
                        int level, int n_threads, Fmt fmt) {
  if (n_threads < 1) n_threads = 1;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  if (chunk < 1) chunk = 1;
  std::vector<std::string> members(static_cast<size_t>(n_threads) + 1);
  std::vector<int64_t> ranges(static_cast<size_t>(n_threads) + 1, 0);
  if (header && header[0]) {
    std::string h(header);
    h.push_back('\n');
    members[0] = gzip_member(h, level);
    if (members[0].empty()) return 1;
  }
  std::vector<std::thread> workers;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n_rows, lo + chunk);
    if (lo >= hi) break;
    ranges[static_cast<size_t>(t) + 1] = hi - lo;
    workers.emplace_back(fmt, lo, hi, &members[static_cast<size_t>(t) + 1]);
  }
  for (auto& w : workers) w.join();
  for (size_t i = 1; i < members.size(); ++i) {
    if (ranges[i] > 0 && members[i].empty()) return 1;  // deflate failed
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  for (auto& m : members) {
    if (!m.empty() && std::fwrite(m.data(), 1, m.size(), f) != m.size()) {
      std::fclose(f);
      return 1;
    }
  }
  return std::fclose(f) == 0 ? 0 : 1;
}

}  // namespace

extern "C" {

// Write a float table as a gzip CSV with %.{sig}g formatting (sig=9
// round-trips float32 exactly): optional header, optional int64 index
// column, (n_rows, n_cols) float64 values. Returns 0 on success.
int fastwrite_ftable(const char* path, const char* header,
                     const int64_t* index, const double* data, int64_t n_rows,
                     int64_t n_cols, char sep, int level, int n_threads,
                     int sig_digits) {
  return write_table_members(
      path, header, n_rows, level, n_threads,
      [=](int64_t lo, int64_t hi, std::string* out) {
        format_rows_f(index, data, n_cols, lo, hi, sep, level, sig_digits,
                      out);
      });
}

// Write an integer table as a gzip CSV: optional header line (verbatim,
// '\n' appended), optional int64 index column, then (n_rows, n_cols) int64
// values. Returns 0 on success.
int fastwrite_table(const char* path, const char* header, const int64_t* index,
                    const int64_t* data, int64_t n_rows, int64_t n_cols,
                    char sep, int level, int n_threads) {
  return write_table_members(
      path, header, n_rows, level, n_threads,
      [=](int64_t lo, int64_t hi, std::string* out) {
        format_rows(index, data, n_cols, lo, hi, sep, level, out);
      });
}

}  // extern "C"
