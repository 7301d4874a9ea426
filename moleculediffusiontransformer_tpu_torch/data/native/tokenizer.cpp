// Native host data path: char-level SMILES tokenization, padding, and
// signed one-hot encoding (the port's own copy of the JAX package's
// data/native/tokenizer.cpp).
//
// The reference's data path rides native code in its dependencies (the
// keras Tokenizer and torch's C++ DataLoader, SURVEY §2.11); this is the
// framework's own equivalent: a multithreaded C++ kernel feeding the
// device input pipeline, exposed over a minimal C ABI for ctypes
// (no pybind11 in this image).
//
// Layouts match data/tokenizer.py exactly:
//   ids:     (n, max_length) int32, post-pad/post-truncate with 0
//   one-hot: (n, max_length, num_classes) float32 in {-1, +1}
//            (eye with zeros remapped to -1 — generative.py:1563-1572)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread, with csv_loader.cpp,
// by data/native/__init__.py at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void tokenize_range(const char* data, const int64_t* offsets,
                    const uint8_t* char_to_id, int64_t max_length,
                    int32_t* out_ids, int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
        const char* s = data + offsets[i];
        const int64_t len = offsets[i + 1] - offsets[i];
        int32_t* row = out_ids + i * max_length;
        int64_t w = 0;
        for (int64_t j = 0; j < len && w < max_length; ++j) {
            const uint8_t id = char_to_id[static_cast<uint8_t>(s[j])];
            if (id != 0) row[w++] = static_cast<int32_t>(id);
            // id 0 = unknown char: dropped, keras semantics
        }
        for (; w < max_length; ++w) row[w] = 0;
    }
}

void onehot_range(const int32_t* ids, int64_t max_length,
                  int64_t num_classes, float* out, int64_t begin,
                  int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
        const int32_t* row = ids + i * max_length;
        float* dst = out + i * max_length * num_classes;
        std::fill(dst, dst + max_length * num_classes, -1.0f);
        for (int64_t t = 0; t < max_length; ++t) {
            const int32_t c = row[t];
            if (c >= 0 && c < num_classes) dst[t * num_classes + c] = 1.0f;
        }
    }
}

template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
    const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    const int64_t n_threads =
        std::min<int64_t>(hw, std::max<int64_t>(1, n / 256));
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

}  // namespace

extern "C" {

// texts are concatenated into `data`; offsets has n+1 entries.
// char_to_id: 256-entry map, 0 = unknown/drop.
int tokenize_pad(const char* data, const int64_t* offsets, int64_t n,
                 const uint8_t* char_to_id, int64_t max_length,
                 int32_t* out_ids) {
    parallel_for(n, [&](int64_t b, int64_t e) {
        tokenize_range(data, offsets, char_to_id, max_length, out_ids, b, e);
    });
    return 0;
}

int one_hot_signed(const int32_t* ids, int64_t n, int64_t max_length,
                   int64_t num_classes, float* out) {
    parallel_for(n, [&](int64_t b, int64_t e) {
        onehot_range(ids, max_length, num_classes, out, b, e);
    });
    return 0;
}

// fused: texts -> padded ids -> signed one-hot in one pass
int tokenize_one_hot(const char* data, const int64_t* offsets, int64_t n,
                     const uint8_t* char_to_id, int64_t max_length,
                     int64_t num_classes, int32_t* ids_scratch, float* out) {
    parallel_for(n, [&](int64_t b, int64_t e) {
        tokenize_range(data, offsets, char_to_id, max_length, ids_scratch,
                       b, e);
        onehot_range(ids_scratch, max_length, num_classes, out, b, e);
    });
    return 0;
}

}  // extern "C"
