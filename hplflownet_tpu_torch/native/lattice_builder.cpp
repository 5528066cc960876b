// Host-side permutohedral lattice builder (C++, sort-based).
//
// The host counterpart of the on-device builder in lattice/build.py: the
// same sort + binary-search design, so both sides produce identical
// tables (dense ids in sorted-key order, stencil-major probe tables, -1
// for an absent vertex).  It fills the role the reference gives to a C
// hash table driven from Numba, for host data paths (offline
// preprocessing, capacity measurement, cross-checks).  The port's own copy
// of the JAX package's native/lattice_builder.cpp, built by bindings.py.
//
// Keys are packed into int64 by the Python caller (21 bits per coordinate,
// biased); offsets are packed deltas.  All functions are thread-safe and
// allocation-free (the caller owns every buffer).

#include <algorithm>
#include <cstdint>

extern "C" {

// Sort + dedup the packed keys of one cloud.
//
//   keys        [n_entries]  packed keys (point-major, remainder-minor)
//   sentinel    key value marking invalid entries (they sort to the end)
//   capacity    static size of the vertex table
//   unique_out  [capacity]   sorted unique keys, sentinel-padded
//   ids_out     [n_entries]  dense vertex id per entry, -1 if absent/invalid
//   scratch     [n_entries]  workspace
//
// Returns the true number of unique keys (may exceed capacity; the excess
// is dropped, mirroring the device builder's overflow semantics).
long long hpl_build_cloud(const long long* keys, long long n_entries,
                          long long sentinel, long long capacity,
                          long long* unique_out, int* ids_out,
                          long long* scratch) {
    for (long long i = 0; i < n_entries; ++i) scratch[i] = keys[i];
    std::sort(scratch, scratch + n_entries);

    long long h = 0;
    for (long long i = 0; i < n_entries; ++i) {
        if (scratch[i] == sentinel) break;
        if (i == 0 || scratch[i] != scratch[i - 1]) {
            if (h < capacity) unique_out[h] = scratch[i];
            ++h;
        }
    }
    long long kept = std::min(h, capacity);
    for (long long i = kept; i < capacity; ++i) unique_out[i] = sentinel;

    long long* end = unique_out + kept;
    for (long long i = 0; i < n_entries; ++i) {
        if (keys[i] == sentinel) { ids_out[i] = -1; continue; }
        const long long* it = std::lower_bound(
            static_cast<const long long*>(unique_out),
            static_cast<const long long*>(end), keys[i]);
        ids_out[i] = (it != end && *it == keys[i])
                         ? static_cast<int>(it - unique_out) : -1;
    }
    return h;
}

// Probe table, stencil-major like the device path: out[j*capacity + i] =
// id of (unique[i] + deltas[j]), -1 if absent.  Sentinel rows yield -1.
void hpl_neighbor_table(const long long* unique, long long capacity,
                        long long num_valid, long long sentinel,
                        const long long* deltas, long long f,
                        int* out) {
    const long long* end = unique + num_valid;
    for (long long i = 0; i < capacity; ++i) {
        const bool valid = i < num_valid && unique[i] != sentinel;
        for (long long j = 0; j < f; ++j) {
            if (!valid) { out[j * capacity + i] = -1; continue; }
            const long long q = unique[i] + deltas[j];
            const long long* it = std::lower_bound(unique, end, q);
            out[j * capacity + i] = (it != end && *it == q)
                                        ? static_cast<int>(it - unique) : -1;
        }
    }
}

// Correlation tables (reference semantics, transforms.py:223-241):
//   pc1_out [cc * cap1]      pc1_out[c*cap1 + i] = id of (key1[i] + corr[c])
//   pc2_out [f * cc * cap1]  pc2_out[(j*cc + c)*cap1 + i] (stencil-major)
void hpl_corr_tables(const long long* unique1, long long cap1, long long n1,
                     const long long* unique2, long long cap2, long long n2,
                     long long sentinel,
                     const long long* corr_deltas, long long cc,
                     const long long* filt_deltas, long long f,
                     int* pc1_out, int* pc2_out) {
    const long long* end1 = unique1 + n1;
    const long long* end2 = unique2 + n2;
    for (long long i = 0; i < cap1; ++i) {
        const bool valid = i < n1 && unique1[i] != sentinel;
        for (long long c = 0; c < cc; ++c) {
            if (!valid) {
                pc1_out[c * cap1 + i] = -1;
                for (long long j = 0; j < f; ++j)
                    pc2_out[(j * cc + c) * cap1 + i] = -1;
                continue;
            }
            const long long center = unique1[i] + corr_deltas[c];
            const long long* it1 = std::lower_bound(unique1, end1, center);
            pc1_out[c * cap1 + i] = (it1 != end1 && *it1 == center)
                                      ? static_cast<int>(it1 - unique1) : -1;
            for (long long j = 0; j < f; ++j) {
                const long long q = center + filt_deltas[j];
                const long long* it2 = std::lower_bound(unique2, end2, q);
                pc2_out[(j * cc + c) * cap1 + i] =
                    (it2 != end2 && *it2 == q)
                        ? static_cast<int>(it2 - unique2) : -1;
            }
        }
    }
}

}  // extern "C"
