// featpack: native host-side feature packing for the input pipeline.
// An own copy of hirest_tpu/native/featpack.cpp for hirest_tpu_torch.
//
// The per-batch hot loop of the data layer — timeline resampling (linspace
// subsample / deterministic repeat-upsample, hirest_tpu/timeline.py
// semantics), ASR segment warping, moment trimming, and zero-padded bucket
// packing — implemented as a small C++ library driven through ctypes.
// Replaces per-example Python/NumPy loops with memcpy-bound native code so
// the host pipeline keeps the device fed.
//
// All buffers are float32 C-contiguous; the Python wrapper owns allocation.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Resample src [src_len, dim] to dst [dst_len, dim]:
//  - src_len > dst_len: linspace index subsample (round-to-floor of
//    i * (src_len - 1) / (dst_len - 1), matching np.linspace(...).astype(int))
//  - src_len <= dst_len: repeat row k into slots [k*dst/src, (k+1)*dst/src)
void resample_rows(const float* src, int64_t src_len,
                   float* dst, int64_t dst_len, int64_t dim) {
    const size_t row = static_cast<size_t>(dim) * sizeof(float);
    if (src_len == dst_len) {
        std::memcpy(dst, src, row * src_len);
        return;
    }
    if (src_len > dst_len) {
        if (dst_len == 1) {
            std::memcpy(dst, src, row);
            return;
        }
        const double step = static_cast<double>(src_len - 1) / (dst_len - 1);
        for (int64_t i = 0; i < dst_len; ++i) {
            // np.linspace pins the endpoint exactly; avoid fp truncation drift
            int64_t k = (i == dst_len - 1) ? src_len - 1
                                           : static_cast<int64_t>(step * i);
            if (k > src_len - 1) k = src_len - 1;
            std::memcpy(dst + i * dim, src + k * dim, row);
        }
        return;
    }
    for (int64_t k = 0; k < src_len; ++k) {
        const int64_t lo = (k * dst_len) / src_len;
        const int64_t hi = ((k + 1) * dst_len) / src_len;
        for (int64_t j = lo; j < hi; ++j) {
            std::memcpy(dst + j * dim, src + k * dim, row);
        }
    }
}

// Pack a batch: for each example i, resample srcs[i] [lens[i], dim] to
// n_model_frames (when > 0) or truncate-copy, then zero-pad to `bucket`
// rows. out is [batch, bucket, dim], zeroed by this function.
// Returns the max effective length across the batch.
int64_t pack_batch(const float** srcs, const int64_t* lens, int64_t batch,
                   int64_t dim, int64_t bucket, int64_t n_model_frames,
                   float* out) {
    const size_t row = static_cast<size_t>(dim) * sizeof(float);
    std::memset(out, 0, static_cast<size_t>(batch) * bucket * row);
    int64_t max_len = 0;
    for (int64_t i = 0; i < batch; ++i) {
        float* dst = out + i * bucket * dim;
        int64_t n;
        if (n_model_frames > 0) {
            n = std::min(n_model_frames, bucket);
            resample_rows(srcs[i], lens[i], dst, n, dim);
        } else {
            n = std::min(lens[i], bucket);
            std::memcpy(dst, srcs[i], row * n);
        }
        max_len = std::max(max_len, n);
    }
    return max_len;
}

// ASR warping: write segment i's vector into seconds [starts[i], ends[i]),
// clamped to [0, n_frames); later segments overwrite earlier ones.
void warp_segments(const float* seg_feats, const int64_t* starts,
                   const int64_t* ends, int64_t n_segs, int64_t dim,
                   int64_t n_frames, float* out) {
    const size_t row = static_cast<size_t>(dim) * sizeof(float);
    std::memset(out, 0, static_cast<size_t>(n_frames) * row);
    for (int64_t i = 0; i < n_segs; ++i) {
        int64_t s = std::max<int64_t>(0, starts[i]);
        int64_t e = std::min<int64_t>(n_frames, ends[i]);
        for (int64_t t = s; t < e; ++t) {
            std::memcpy(out + t * dim, seg_feats + i * dim, row);
        }
    }
}

// Moment trim: gather rows where mask == 1, then truncate or
// repeat-upsample to exactly `target` rows (modeling.py:529-554 semantics).
// scratch must hold [t, dim] floats.
void trim_to_moment(const float* feats, const int32_t* mask, int64_t t,
                    int64_t dim, int64_t target, float* scratch, float* out) {
    const size_t row = static_cast<size_t>(dim) * sizeof(float);
    int64_t n = 0;
    for (int64_t i = 0; i < t; ++i) {
        if (mask[i]) {
            std::memcpy(scratch + n * dim, feats + i * dim, row);
            ++n;
        }
    }
    if (target < n) {
        std::memcpy(out, scratch, row * target);  // truncate
        return;
    }
    for (int64_t k = 0; k < n; ++k) {  // repeat-upsample
        const int64_t lo = (k * target) / n;
        const int64_t hi = ((k + 1) * target) / n;
        for (int64_t j = lo; j < hi; ++j) {
            std::memcpy(out + j * dim, scratch + k * dim, row);
        }
    }
}

}  // extern "C"
