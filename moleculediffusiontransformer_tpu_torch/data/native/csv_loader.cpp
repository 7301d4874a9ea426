// Native host data path: plain (unquoted) CSV parsing for the QM9 table
// (the port's own copy of the JAX package's data/native/csv_loader.cpp).
//
// The reference loads qm9_.csv through pandas' C engine
// (Inverse_Diffusion.ipynb cell 30; SURVEY §2.8); this is the framework's
// own native reader: one serial newline scan to index rows, then a
// multithreaded field split + float parse.  Exposed over the same C ABI
// .so as tokenizer.cpp (ctypes, no pybind11 in this image).
//
// Parity contract with data/qm9.py::load_qm9 (csv.DictReader + Python
// float): floats are parsed as DOUBLE then narrowed to f32 by the caller's
// np.float32 array — strtod here reproduces Python float() exactly,
// including scientific notation.  Quoted CSVs are rejected host-side in
// Python before this is called (csv.DictReader semantics differ there).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (with tokenizer.cpp)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Shared with tokenizer.cpp (anonymous namespace keeps them separate
// symbols; duplicated 15 lines beat a header for a 2-file library).
template <typename Fn>
void parallel_for_rows(int64_t n, Fn fn) {
    const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    const int64_t n_threads =
        std::min<int64_t>(hw, std::max<int64_t>(1, n / 1024));
    if (n_threads <= 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
        const int64_t b = t * chunk;
        const int64_t e = std::min(n, b + chunk);
        if (b >= e) break;
        threads.emplace_back([=] { fn(b, e); });
    }
    for (auto& th : threads) th.join();
}

// Line-start offsets: offsets[i] = byte index where line i begins.
// Returns total line count (lines with any content; a trailing "\n" does
// not create an empty final line).
std::vector<int64_t> line_starts(const char* data, int64_t len) {
    std::vector<int64_t> starts;
    int64_t pos = 0;
    while (pos < len) {
        starts.push_back(pos);
        const void* nl = memchr(data + pos, '\n', len - pos);
        if (nl == nullptr) break;
        pos = static_cast<const char*>(nl) - data + 1;
    }
    return starts;
}

struct Span {
    int64_t begin, end;
};

// Split one line (without trailing \n / \r) into comma fields.
void split_fields(const char* data, int64_t begin, int64_t end,
                  std::vector<Span>& fields) {
    fields.clear();
    int64_t fb = begin;
    for (int64_t i = begin; i <= end; ++i) {
        if (i == end || data[i] == ',') {
            fields.push_back({fb, i});
            fb = i + 1;
        }
    }
}

// strtod needs NUL termination; fields are short, copy to a stack buffer.
bool parse_double(const char* data, Span f, double* out) {
    char buf[64];
    const int64_t n = f.end - f.begin;
    if (n <= 0 || n >= static_cast<int64_t>(sizeof(buf))) return false;
    memcpy(buf, data + f.begin, n);
    buf[n] = '\0';
    char* endp = nullptr;
    *out = strtod(buf, &endp);
    // trailing spaces tolerated (Python float() strips whitespace)
    while (endp && *endp == ' ') ++endp;
    return endp == buf + n;
}

}  // namespace

extern "C" {

// Number of data rows (lines after the header).
int64_t csv_count_rows(const char* data, int64_t len) {
    const auto starts = line_starts(data, len);
    return starts.empty() ? 0 : static_cast<int64_t>(starts.size()) - 1;
}

// Parse the first n_rows data rows.
//   smiles_spans: (n_rows, 2) int64 byte ranges of the SMILES field
//   props:        (n_rows, n_props) float32
// Column indices are 0-based positions in the header.  Returns 0 on
// success, -(row+1) for the first malformed data row (short line, bad
// float, field too long) — the caller falls back to the Python parser,
// which raises the user-facing error.
int64_t csv_parse_rows(const char* data, int64_t len, int64_t n_rows,
                       int64_t smiles_col, const int64_t* prop_cols,
                       int64_t n_props, int64_t* smiles_spans,
                       float* props) {
    const auto starts = line_starts(data, len);
    if (static_cast<int64_t>(starts.size()) < n_rows + 1) {
        return -1;
    }
    int64_t max_col = smiles_col;
    for (int64_t j = 0; j < n_props; ++j) {
        max_col = std::max(max_col, prop_cols[j]);
    }
    std::vector<int64_t> status(n_rows, 0);
    parallel_for_rows(n_rows, [&](int64_t b, int64_t e) {
        std::vector<Span> fields;
        fields.reserve(max_col + 4);
        for (int64_t i = b; i < e; ++i) {
            const int64_t lb = starts[i + 1];  // skip header line
            int64_t le = (i + 2 < static_cast<int64_t>(starts.size()))
                             ? starts[i + 2]
                             : len;
            if (le > lb && data[le - 1] == '\n') --le;
            if (le > lb && data[le - 1] == '\r') --le;  // CRLF
            split_fields(data, lb, le, fields);
            if (static_cast<int64_t>(fields.size()) <= max_col) {
                status[i] = 1;
                continue;
            }
            smiles_spans[2 * i] = fields[smiles_col].begin;
            smiles_spans[2 * i + 1] = fields[smiles_col].end;
            for (int64_t j = 0; j < n_props; ++j) {
                double v;
                if (!parse_double(data, fields[prop_cols[j]], &v)) {
                    status[i] = 1;
                    break;
                }
                // double -> float narrowing matches Python
                // np.float32(float(s)) bit-for-bit
                props[i * n_props + j] = static_cast<float>(v);
            }
        }
    });
    for (int64_t i = 0; i < n_rows; ++i) {
        if (status[i]) return -(i + 1);
    }
    return 0;
}

}  // extern "C"
