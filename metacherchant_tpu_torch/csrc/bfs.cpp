// Native FIFO environment-BFS engine (exact + hashed regimes).
//
// The environment BFS is inherently sequential on deep-narrow gene graphs
// (the wiki example runs ~93k layers at frontier <= 31), so the hot loop
// belongs on the host, in native code -- the TPU analogue of the reference's
// Java String-keyed FIFO (src/algo/OneSequenceCalculator.java:198-239) with
// the strings replaced by 2-bit packed codes (k <= 31) or byte rows + 64-bit
// canonical hashes (k > 31). Semantics preserved exactly:
//   - seeds enqueued in order, duplicates included (runBfs:159-196)
//   - neighbor order: left n+s[:-1] / right s[1:]+n for n in code order
//     A,G,C,T; direction 0 interleaves L0,R0,L1,R1,... (StringUtils:8-32)
//   - admission: count >= minOccurences AND not visited AND |visited| <
//     maxkmers AND dist <= maxradius (TerminationMode.allowsAddition:31-47;
//     MAX_KMERS is admission-order dependent -- FIFO order makes it exact)
//   - lastKmers: parent flagged when an eligible neighbor is not admitted
//     (runBfs:209)
// Hashes replicate the Java functions bit-for-bit on uint64 wraparound:
// poly h=1; h=h*5+c (src/utils/PolynomialHash.java:19-28); fnv1a
// h=basis; h=(h^c)*prime (src/utils/FNV1AHash.java:33-42); key = signed
// min(fw, rc). Exactness is pinned against the Python engines and the
// JAX package's native library in tests/test_torch_native_bfs.py.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr uint64_t FNV_BASIS = 14695981039346656037ULL;
constexpr uint64_t FNV_PRIME = 1099511628211ULL;

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

static inline uint64_t revcomp64(uint64_t v, int k) {
    v = ~v;
    v = ((v & 0x3333333333333333ULL) << 2) | ((v >> 2) & 0x3333333333333333ULL);
    v = ((v & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((v >> 4) & 0x0F0F0F0F0F0F0F0FULL);
    v = __builtin_bswap64(v);
    return v >> (64 - 2 * k);
}

// count lookup in the caller's map: a view of its sorted keys (strictly
// increasing, KmerMap's invariant) and their counts, searched per lookup.
// A direction walks thousands of k-mers, so a search (~1 us) beats a hash
// table of the whole map (seconds to build at 25M keys).
struct CountMap {
    const int64_t* keys;
    const int32_t* cnts;
    int64_t n;

    inline int32_t get(int64_t key) const {  // -1 if absent
        const int64_t* p = std::lower_bound(keys, keys + n, key);
        return (p != keys + n && *p == key) ? cnts[p - keys] : -1;
    }
};

// visited map for the exact regime: oriented code -> (dist, last flag)
struct VisitedExact {
    std::vector<int64_t> keys;
    std::vector<int32_t> dist;
    std::vector<uint8_t> state;  // 0 empty, 1 used, 3 used+last
    uint64_t mask = 0;
    int64_t count = 0;

    void init(uint64_t cap0 = 1 << 16) {
        uint64_t cap = 16;
        while (cap < cap0) cap <<= 1;
        keys.assign(cap, 0); dist.assign(cap, 0); state.assign(cap, 0);
        mask = cap - 1; count = 0;
    }
    void grow() {
        VisitedExact bigger;
        bigger.init((mask + 1) * 2);
        for (uint64_t i = 0; i <= mask; i++)
            if (state[i]) {
                uint64_t h = splitmix64((uint64_t)keys[i]) & bigger.mask;
                while (bigger.state[h]) h = (h + 1) & bigger.mask;
                bigger.keys[h] = keys[i]; bigger.dist[h] = dist[i];
                bigger.state[h] = state[i];
            }
        bigger.count = count;
        *this = std::move(bigger);
    }
    inline int64_t find(int64_t key) const {  // slot or -1
        uint64_t h = splitmix64((uint64_t)key) & mask;
        while (state[h]) {
            if (keys[h] == key) return (int64_t)h;
            h = (h + 1) & mask;
        }
        return -1;
    }
    inline void insert(int64_t key, int32_t d) {
        if ((uint64_t)count * 10 > (mask + 1) * 7) grow();
        uint64_t h = splitmix64((uint64_t)key) & mask;
        while (state[h]) h = (h + 1) & mask;
        keys[h] = key; dist[h] = d; state[h] = 1; count++;
    }
};

template <typename T>
static T* copy_out(const std::vector<T>& v) {
    T* p = (T*)malloc(std::max<size_t>(v.size() * sizeof(T), 1));
    if (!v.empty()) memcpy(p, v.data(), v.size() * sizeof(T));
    return p;
}

}  // namespace

extern "C" {

void mc_bfs_free(void* p) { free(p); }

// Exact regime (k <= 31): packed 2-bit oriented codes.
int mc_bfs_exact(const int64_t* map_keys, const int32_t* map_cnts,
                 int64_t map_n, const int64_t* seeds, int64_t n_seeds,
                 int k, int min_occ, int direction, int64_t max_radius,
                 int64_t max_kmers, int collect_last,
                 int64_t** out_vis, int64_t* out_nvis,
                 int64_t** out_last, int64_t* out_nlast) {
    const CountMap cm{map_keys, map_cnts, map_n};
    VisitedExact vis;
    vis.init();
    std::vector<int64_t> queue;
    queue.reserve(n_seeds > 1024 ? (size_t)n_seeds : 1024);
    for (int64_t i = 0; i < n_seeds; i++) {
        int64_t s = seeds[i];
        if (vis.find(s) < 0) vis.insert(s, 0);
        queue.push_back(s);  // duplicates enqueued, as in Java
    }
    const uint64_t mask = ((uint64_t)1 << (2 * k)) - 1;
    const int shift_hi = 2 * k - 2;
    size_t head = 0;
    int64_t nbrs[8];
    int nn = (direction == 0) ? 8 : 4;
    while (head < queue.size()) {
        int64_t cur = queue[head++];
        int64_t cur_slot = vis.find(cur);
        int32_t dd = vis.dist[cur_slot] + 1;
        uint64_t c = (uint64_t)cur;
        if (direction == -1) {
            uint64_t sh = c >> 2;
            for (int n = 0; n < 4; n++)
                nbrs[n] = (int64_t)(sh | ((uint64_t)n << shift_hi));
        } else if (direction == 1) {
            uint64_t sl = (c << 2) & mask;
            for (int n = 0; n < 4; n++) nbrs[n] = (int64_t)(sl | (uint64_t)n);
        } else {
            uint64_t sh = c >> 2, sl = (c << 2) & mask;
            for (int n = 0; n < 4; n++) {
                nbrs[2 * n] = (int64_t)(sh | ((uint64_t)n << shift_hi));
                nbrs[2 * n + 1] = (int64_t)(sl | (uint64_t)n);
            }
        }
        bool flagged = false;
        for (int j = 0; j < nn; j++) {
            int64_t nb = nbrs[j];
            uint64_t rc = revcomp64((uint64_t)nb, k);
            int64_t key = (int64_t)std::min((uint64_t)nb, rc);
            int32_t oc = cm.get(key);
            if (oc < 0 || oc < min_occ) continue;
            bool allowed = vis.find(nb) < 0;
            if (allowed && max_kmers >= 0 && vis.count >= max_kmers)
                allowed = false;
            if (allowed && max_radius >= 0 && dd > max_radius) allowed = false;
            if (allowed) {
                vis.insert(nb, dd);
                queue.push_back(nb);
            } else if (collect_last && !flagged) {
                // re-find: insert may have rehashed/moved the slot
                vis.state[vis.find(cur)] = 3;
                flagged = true;
            }
        }
    }
    std::vector<int64_t> all, last;
    all.reserve((size_t)vis.count);
    for (uint64_t i = 0; i <= vis.mask; i++) {
        if (vis.state[i]) all.push_back(vis.keys[i]);
        if (vis.state[i] == 3) last.push_back(vis.keys[i]);
    }
    std::sort(all.begin(), all.end());
    std::sort(last.begin(), last.end());
    *out_vis = copy_out(all); *out_nvis = (int64_t)all.size();
    *out_last = copy_out(last); *out_nlast = (int64_t)last.size();
    return 0;
}

namespace {

// visited map for the hashed regime: k-byte state rows in an arena
struct VisitedHashed {
    std::vector<uint8_t>* arena;
    int k;
    std::vector<int64_t> idx;    // arena row index
    std::vector<int32_t> dist;
    std::vector<uint8_t> state;  // 0 empty, 1 used, 3 used+last
    uint64_t mask = 0;
    int64_t count = 0;

    void init(std::vector<uint8_t>* a, int kk, uint64_t cap0 = 1 << 16) {
        arena = a; k = kk;
        uint64_t cap = 16;
        while (cap < cap0) cap <<= 1;
        idx.assign(cap, 0); dist.assign(cap, 0); state.assign(cap, 0);
        mask = cap - 1; count = 0;
    }
    inline uint64_t hash_bytes(const uint8_t* p) const {
        uint64_t h = FNV_BASIS;
        for (int i = 0; i < k; i++) h = (h ^ p[i]) * FNV_PRIME;
        return splitmix64(h);
    }
    inline const uint8_t* row(int64_t i) const {
        return arena->data() + (size_t)i * k;
    }
    inline int64_t find(const uint8_t* p) const {
        uint64_t h = hash_bytes(p) & mask;
        while (state[h]) {
            if (memcmp(row(idx[h]), p, k) == 0) return (int64_t)h;
            h = (h + 1) & mask;
        }
        return -1;
    }
    void grow() {
        std::vector<int64_t> oi = std::move(idx);
        std::vector<int32_t> od = std::move(dist);
        std::vector<uint8_t> os = std::move(state);
        uint64_t ocap = mask + 1;
        init(arena, k, ocap * 2);
        for (uint64_t i = 0; i < ocap; i++)
            if (os[i]) {
                uint64_t h = hash_bytes(row(oi[i])) & mask;
                while (state[h]) h = (h + 1) & mask;
                idx[h] = oi[i]; dist[h] = od[i]; state[h] = os[i];
                count++;
            }
    }
    // inserts p (copying into the arena); returns arena row index
    inline int64_t insert(const uint8_t* p, int32_t d) {
        if ((uint64_t)count * 10 > (mask + 1) * 7) grow();
        int64_t r = (int64_t)(arena->size() / k);
        arena->insert(arena->end(), p, p + k);
        uint64_t h = hash_bytes(p) & mask;
        while (state[h]) h = (h + 1) & mask;
        idx[h] = r; dist[h] = d; state[h] = 1; count++;
        return r;
    }
};

static inline int64_t hash_row(const uint8_t* p, int k, int hasher_id) {
    uint64_t fw, rc;
    if (hasher_id == 0) {  // poly
        fw = 1; rc = 1;
        for (int t = 0; t < k; t++) {
            fw = fw * 5 + p[t];
            rc = rc * 5 + (uint64_t)(p[k - 1 - t] ^ 3);
        }
    } else {  // fnv1a
        fw = FNV_BASIS; rc = FNV_BASIS;
        for (int t = 0; t < k; t++) {
            fw = (fw ^ (uint64_t)p[t]) * FNV_PRIME;
            rc = (rc ^ (uint64_t)(p[k - 1 - t] ^ 3)) * FNV_PRIME;
        }
    }
    int64_t sf = (int64_t)fw, sr = (int64_t)rc;
    return sf < sr ? sf : sr;
}

}  // namespace

// Hashed regime (k > 31): byte-row states, 64-bit canonical Java hashes.
// hasher_id: 0 = poly, 1 = fnv1a.
int mc_bfs_hashed(const int64_t* map_keys, const int32_t* map_cnts,
                  int64_t map_n, const uint8_t* seeds, int64_t n_seeds,
                  int k, int min_occ, int direction, int64_t max_radius,
                  int64_t max_kmers, int hasher_id, int collect_last,
                  uint8_t** out_vis, int64_t* out_nvis,
                  uint8_t** out_last, int64_t* out_nlast) {
    const CountMap cm{map_keys, map_cnts, map_n};
    std::vector<uint8_t> arena;
    arena.reserve((size_t)std::max<int64_t>(n_seeds, 1024) * k);
    VisitedHashed vis;
    vis.init(&arena, k);
    std::vector<int64_t> queue;  // arena row indices
    for (int64_t i = 0; i < n_seeds; i++) {
        const uint8_t* p = seeds + (size_t)i * k;
        int64_t slot = vis.find(p);
        int64_t r = slot >= 0 ? -1 : vis.insert(p, 0);
        if (slot >= 0) {
            // duplicate seed: enqueue the EXISTING row (Java enqueues the
            // string itself; identity is by value either way)
            r = vis.idx[slot];
        }
        queue.push_back(r);
    }
    std::vector<uint8_t> buf(k);
    size_t head = 0;
    while (head < queue.size()) {
        int64_t cur_row = queue[head++];
        // arena may reallocate on insert: recompute pointers each use
        int64_t cur_slot = vis.find(arena.data() + (size_t)cur_row * k);
        int32_t dd = vis.dist[cur_slot] + 1;
        bool flagged = false;
        // neighbor order: dir -1 -> L0..L3; dir 1 -> R0..R3;
        // dir 0 -> L0,R0,L1,R1,... (StringUtils.allNeighbors:24-32)
        int total = (direction == 0) ? 8 : 4;
        for (int j = 0; j < total; j++) {
            int n, is_left;
            if (direction == -1) { n = j; is_left = 1; }
            else if (direction == 1) { n = j; is_left = 0; }
            else { n = j / 2; is_left = (j % 2 == 0); }
            const uint8_t* cur = arena.data() + (size_t)cur_row * k;
            if (is_left) {
                buf[0] = (uint8_t)n;
                memcpy(buf.data() + 1, cur, k - 1);
            } else {
                memcpy(buf.data(), cur + 1, k - 1);
                buf[k - 1] = (uint8_t)n;
            }
            int64_t key = hash_row(buf.data(), k, hasher_id);
            int32_t oc = cm.get(key);
            if (oc < 0 || oc < min_occ) continue;
            bool allowed = vis.find(buf.data()) < 0;
            if (allowed && max_kmers >= 0 && vis.count >= max_kmers)
                allowed = false;
            if (allowed && max_radius >= 0 && dd > max_radius) allowed = false;
            if (allowed) {
                queue.push_back(vis.insert(buf.data(), dd));
            } else if (collect_last && !flagged) {
                vis.state[vis.find(arena.data() + (size_t)cur_row * k)] = 3;
                flagged = true;
            }
        }
    }
    std::vector<uint8_t> all, last;
    all.reserve((size_t)vis.count * k);
    for (uint64_t i = 0; i <= vis.mask; i++) {
        if (vis.state[i]) {
            const uint8_t* p = vis.row(vis.idx[i]);
            all.insert(all.end(), p, p + k);
            if (vis.state[i] == 3) last.insert(last.end(), p, p + k);
        }
    }
    *out_vis = copy_out(all); *out_nvis = (int64_t)(all.size() / k);
    *out_last = copy_out(last); *out_nlast = (int64_t)(last.size() / k);
    return 0;
}

}  // extern "C"
