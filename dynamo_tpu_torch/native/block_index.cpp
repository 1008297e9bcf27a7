// Concurrent KV block index: the native core of the router's indexer.
//
// A copy of the reference's native/block_index.cpp (a sharded hash index
// over lineage block hashes with per-worker residency sets), built by
// dynamo_tpu_torch/native/block_index.py with g++ at first use and bound
// with ctypes.
//
// Concurrency design:
//   - nodes live in 64 hash-sharded maps, each behind its own std::mutex;
//     every critical section is a single node touch, so readers and
//     writers interleave fairly and in parallel across shards
//   - find_matches copies each node's small worker set out under the
//     shard lock, then intersects lock-free; a lookup sees each BLOCK
//     atomically but not the whole chain, so scores can be momentarily
//     stale while an event storm lands, which the routing cost model
//     tolerates
//   - cross-shard bookkeeping (parent child counts, pruning cascades)
//     takes locks strictly one at a time and re-validates under each
//     lock; the worst interleaving leaks or early-prunes one node, never
//     dangles a pointer (parents are looked up by hash, and a miss is
//     handled)
//   - per-worker residency sets are striped 16 ways by worker id
//
// Workers are dense u32 indices assigned by the Python wrapper; block
// hashes are the u64 lineage hashes of dynamo_tpu_torch.tokens.hashing.
// Exposed through a C ABI for ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC block_index.cpp -o libblock_index.so

#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Node {
    uint64_t parent = 0;
    bool has_parent = false;
    // small worker sets: linear vectors beat hash sets for <32 entries
    std::vector<uint32_t> workers;
    uint32_t n_children = 0;

    bool has_worker(uint32_t w) const {
        for (uint32_t x : workers)
            if (x == w) return true;
        return false;
    }
    void add_worker(uint32_t w) {
        if (!has_worker(w)) workers.push_back(w);
    }
    bool remove_worker(uint32_t w) {
        for (size_t i = 0; i < workers.size(); ++i) {
            if (workers[i] == w) {
                workers[i] = workers.back();
                workers.pop_back();
                return true;
            }
        }
        return false;
    }
};

constexpr int kNodeShards = 64;
constexpr int kWorkerStripes = 16;

struct NodeShard {
    std::mutex mu;
    std::unordered_map<uint64_t, Node> nodes;
};

struct WorkerStripe {
    std::mutex mu;
    std::unordered_map<uint32_t, std::unordered_set<uint64_t>> blocks;
};

struct BlockIndex {
    NodeShard shards[kNodeShards];
    WorkerStripe worker_stripes[kWorkerStripes];

    static int shard_of(uint64_t h) {
        return (int)((h * 0x9E3779B97F4A7C15ull) >> 58) & (kNodeShards - 1);
    }
    NodeShard &shard(uint64_t h) { return shards[shard_of(h)]; }
    WorkerStripe &stripe(uint32_t w) {
        return worker_stripes[w & (kWorkerStripes - 1)];
    }

    // -- per-block ops (each acquires exactly one shard lock at a time) --

    // insert/refresh one chain block; returns nothing. Parent child-count
    // bump happens under the PARENT's shard lock, taken after this
    // block's lock is released (strict one-lock-at-a-time rule).
    void store_block(uint32_t w, uint64_t h, uint64_t parent, bool has_parent) {
        bool inserted = false;
        {
            NodeShard &s = shard(h);
            std::lock_guard lk(s.mu);
            auto [it, ins] = s.nodes.try_emplace(h);
            if (ins) {
                it->second.parent = parent;
                it->second.has_parent = has_parent;
                inserted = true;
            }
            it->second.add_worker(w);
        }
        if (inserted && has_parent) {
            NodeShard &ps = shard(parent);
            std::lock_guard lk(ps.mu);
            auto pit = ps.nodes.find(parent);
            if (pit != ps.nodes.end()) pit->second.n_children++;
        }
    }

    // drop a worker from a block; prune the orphan cascade upward
    void remove_worker_block(uint32_t w, uint64_t h) {
        {
            NodeShard &s = shard(h);
            std::lock_guard lk(s.mu);
            auto it = s.nodes.find(h);
            if (it == s.nodes.end()) return;
            it->second.remove_worker(w);
        }
        prune_chain(h);
    }

    void prune_chain(uint64_t h) {
        while (true) {
            uint64_t parent = 0;
            bool has_parent = false;
            {
                NodeShard &s = shard(h);
                std::lock_guard lk(s.mu);
                auto it = s.nodes.find(h);
                if (it == s.nodes.end()) return;
                Node &n = it->second;
                // re-validate under the lock: a concurrent store may have
                // re-added a worker or child since the caller's check
                if (!n.workers.empty() || n.n_children > 0) return;
                parent = n.parent;
                has_parent = n.has_parent;
                s.nodes.erase(it);
            }
            if (!has_parent) return;
            {
                NodeShard &ps = shard(parent);
                std::lock_guard lk(ps.mu);
                auto pit = ps.nodes.find(parent);
                if (pit == ps.nodes.end()) return;
                if (pit->second.n_children > 0) pit->second.n_children--;
                if (!pit->second.workers.empty() || pit->second.n_children > 0)
                    return;
            }
            h = parent;
        }
    }
};

}  // namespace

extern "C" {

void *bi_new() { return new BlockIndex(); }

void bi_free(void *p) { delete static_cast<BlockIndex *>(p); }

// store: hashes form a lineage chain; parent0 anchors hashes[0]
// (has_parent0 = 0 means hashes[0] is a root block)
void bi_apply_store(void *p, uint32_t worker, uint64_t parent0,
                    int has_parent0, const uint64_t *hashes, int n) {
    auto *bi = static_cast<BlockIndex *>(p);
    uint64_t parent = parent0;
    bool has_parent = has_parent0 != 0;
    for (int i = 0; i < n; ++i) {
        uint64_t h = hashes[i];
        bi->store_block(worker, h, parent, has_parent);
        parent = h;
        has_parent = true;
    }
    {
        auto &st = bi->stripe(worker);
        std::lock_guard lk(st.mu);
        auto &set = st.blocks[worker];
        for (int i = 0; i < n; ++i) set.insert(hashes[i]);
    }
}

void bi_apply_remove(void *p, uint32_t worker, const uint64_t *hashes, int n) {
    auto *bi = static_cast<BlockIndex *>(p);
    for (int i = 0; i < n; ++i) bi->remove_worker_block(worker, hashes[i]);
    {
        auto &st = bi->stripe(worker);
        std::lock_guard lk(st.mu);
        auto wit = st.blocks.find(worker);
        if (wit != st.blocks.end())
            for (int i = 0; i < n; ++i) wit->second.erase(hashes[i]);
    }
}

void bi_remove_worker(void *p, uint32_t worker) {
    auto *bi = static_cast<BlockIndex *>(p);
    std::vector<uint64_t> blocks;
    {
        auto &st = bi->stripe(worker);
        std::lock_guard lk(st.mu);
        auto wit = st.blocks.find(worker);
        if (wit == st.blocks.end()) return;
        blocks.assign(wit->second.begin(), wit->second.end());
        st.blocks.erase(wit);
    }
    for (uint64_t h : blocks) bi->remove_worker_block(worker, h);
}

// find_matches: walk the chain; score[w] = contiguous leading blocks w
// holds. out_workers/out_scores sized max_out; returns count written.
// Each block is read atomically (copied out under its shard lock); the
// chain as a whole is not a snapshot — see the header note.
int bi_find_matches(void *p, const uint64_t *hashes, int n,
                    uint32_t *out_workers, uint32_t *out_scores, int max_out) {
    auto *bi = static_cast<BlockIndex *>(p);
    std::vector<uint32_t> alive;  // workers matching blocks [0, i)
    std::vector<uint32_t> final_workers;
    std::vector<uint32_t> final_scores;
    std::vector<uint32_t> cur;

    int i = 0;
    for (; i < n; ++i) {
        uint64_t h = hashes[i];
        bool found = false;
        cur.clear();
        {
            NodeShard &s = bi->shard(h);
            std::lock_guard lk(s.mu);
            auto it = s.nodes.find(h);
            if (it != s.nodes.end()) {
                found = true;
                cur = it->second.workers;  // small copy-out
            }
        }
        if (!found) break;
        auto holds = [&](uint32_t w) {
            for (uint32_t x : cur)
                if (x == w) return true;
            return false;
        };
        if (i == 0) {
            alive = cur;
        } else {
            std::vector<uint32_t> still;
            still.reserve(alive.size());
            for (uint32_t w : alive) {
                if (holds(w)) {
                    still.push_back(w);
                } else {
                    // dropped out: keeps the score accumulated so far
                    final_workers.push_back(w);
                    final_scores.push_back(static_cast<uint32_t>(i));
                }
            }
            alive.swap(still);
        }
        if (alive.empty()) break;
    }
    // survivors matched i leading blocks
    for (uint32_t w : alive) {
        final_workers.push_back(w);
        final_scores.push_back(static_cast<uint32_t>(i));
    }

    int count = 0;
    for (size_t j = 0; j < final_workers.size() && count < max_out; ++j) {
        out_workers[count] = final_workers[j];
        out_scores[count] = final_scores[j];
        count++;
    }
    return count;
}

uint64_t bi_len(void *p) {
    auto *bi = static_cast<BlockIndex *>(p);
    uint64_t total = 0;
    for (int i = 0; i < kNodeShards; ++i) {
        std::lock_guard lk(bi->shards[i].mu);
        total += bi->shards[i].nodes.size();
    }
    return total;
}

uint64_t bi_worker_block_count(void *p, uint32_t worker) {
    auto *bi = static_cast<BlockIndex *>(p);
    auto &st = bi->stripe(worker);
    std::lock_guard lk(st.mu);
    auto it = st.blocks.find(worker);
    return it == st.blocks.end() ? 0 : it->second.size();
}

}  // extern "C"
