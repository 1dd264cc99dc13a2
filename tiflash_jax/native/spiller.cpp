// Native spill subsystem — partition-wise spill files with compressed
// chunks and a background writer pool.
//
// Role analog: the reference's disk-spill tier —
//   /root/reference/dbms/src/Core/Spiller.h:87 (partition-wise spill
//   files of compressed blocks), SpillHandler, and the background IO
//   the pipeline model routes through its IO thread pool.
// Re-design: the engine's operators never spill mid-kernel (jitted
// programs are uninterruptible); the HOST out-of-core driver
// (runtime/outofcore.py) stages partition buffers, and this library is
// its disk tier: zlib-compressed chunk files, CRC-checked, written by a
// small background pool so device compute overlaps spill IO.
//
// C ABI (ctypes): every function is extern "C"; handles are opaque.
//
// File format per chunk ("TFS1"):
//   magic u32 'TFS1' | raw_size u64 | comp_size u64 | crc32(raw) u32
//   | comp_size bytes of zlib deflate
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint32_t kMagic = 0x31534654;  // "TFS1"

struct ChunkMeta {
    std::string path;
    uint64_t raw_size = 0;
    uint64_t comp_size = 0;
    std::atomic<int> state{0};  // 0 = pending, 1 = done, -1 = failed
};

struct WriteJob {
    int chunk_id;
    std::vector<uint8_t> data;  // owned copy (caller buffer is transient)
    int level;
};

struct Spiller {
    std::string dir;
    std::mutex mu;
    std::vector<ChunkMeta*> chunks;
    std::deque<WriteJob> queue;
    std::condition_variable cv;
    std::condition_variable idle_cv;
    std::vector<std::thread> workers;
    std::atomic<uint64_t> bytes_raw{0};
    std::atomic<uint64_t> bytes_comp{0};
    std::atomic<int> inflight{0};
    bool stop = false;

    explicit Spiller(const std::string& d, int nthreads) : dir(d) {
        // nthreads <= 0 means "hardware concurrency", matching the
        // loader (loader.cpp) and the max_threads=0 settings contract.
        if (nthreads < 1)
            nthreads = std::max(2u, std::thread::hardware_concurrency());
        for (int i = 0; i < nthreads; i++)
            workers.emplace_back([this] { run(); });
    }

    ~Spiller() {
        {
            std::unique_lock<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& t : workers) t.join();
        for (auto* c : chunks) delete c;
    }

    void run() {
        for (;;) {
            WriteJob job;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [this] { return stop || !queue.empty(); });
                if (queue.empty()) {
                    if (stop) return;
                    continue;
                }
                job = std::move(queue.front());
                queue.pop_front();
            }
            do_write(job);
            if (--inflight == 0) idle_cv.notify_all();
        }
    }

    void do_write(WriteJob& job) {
        ChunkMeta* meta;
        {
            std::unique_lock<std::mutex> lk(mu);
            meta = chunks[job.chunk_id];
        }
        uLongf bound = compressBound(job.data.size());
        std::vector<uint8_t> comp(bound);
        int rc = compress2(comp.data(), &bound, job.data.data(),
                           job.data.size(), job.level);
        if (rc != Z_OK) {
            meta->state.store(-1);
            return;
        }
        uint32_t crc = crc32(0L, job.data.data(), job.data.size());
        FILE* f = fopen(meta->path.c_str(), "wb");
        if (!f) {
            meta->state.store(-1);
            return;
        }
        uint32_t magic = kMagic;
        uint64_t raw = job.data.size(), cs = bound;
        bool ok = fwrite(&magic, 4, 1, f) == 1 && fwrite(&raw, 8, 1, f) == 1 &&
                  fwrite(&cs, 8, 1, f) == 1 && fwrite(&crc, 4, 1, f) == 1 &&
                  (cs == 0 || fwrite(comp.data(), 1, cs, f) == cs);
        fclose(f);
        if (!ok) {
            meta->state.store(-1);
            return;
        }
        meta->raw_size = raw;
        meta->comp_size = cs;
        bytes_raw += raw;
        bytes_comp += cs;
        meta->state.store(1);
    }
};

}  // namespace

extern "C" {

void* spl_open(const char* dir, int nthreads) {
    return new Spiller(dir, nthreads);
}

// Enqueue one chunk write; returns the chunk id immediately (background
// compression+write).  partition tags the file name for debuggability.
int spl_write(void* h, int partition, const void* data, int64_t nbytes,
              int level) {
    auto* s = static_cast<Spiller*>(h);
    if (nbytes < 0) return -1;
    WriteJob job;
    job.level = level <= 0 ? 1 : level;
    job.data.assign(static_cast<const uint8_t*>(data),
                    static_cast<const uint8_t*>(data) + nbytes);
    int id;
    {
        std::unique_lock<std::mutex> lk(s->mu);
        id = static_cast<int>(s->chunks.size());
        auto* meta = new ChunkMeta();
        char name[64];
        snprintf(name, sizeof name, "/p%04d_c%06d.spl", partition, id);
        meta->path = s->dir + name;
        s->chunks.push_back(meta);
        job.chunk_id = id;
        s->inflight++;
        s->queue.push_back(std::move(job));
    }
    s->cv.notify_one();
    return id;
}

// Block until every queued write has landed; returns 0 on success,
// -1 if any chunk failed.
int spl_sync(void* h) {
    auto* s = static_cast<Spiller*>(h);
    {
        std::unique_lock<std::mutex> lk(s->mu);
        s->idle_cv.wait(lk, [s] { return s->inflight.load() == 0; });
    }
    for (auto* c : s->chunks)
        if (c->state.load() == -1) return -1;
    return 0;
}

int64_t spl_chunk_raw_size(void* h, int chunk_id) {
    auto* s = static_cast<Spiller*>(h);
    std::unique_lock<std::mutex> lk(s->mu);
    if (chunk_id < 0 || chunk_id >= (int)s->chunks.size()) return -1;
    ChunkMeta* m = s->chunks[chunk_id];
    lk.unlock();
    while (m->state.load() == 0) std::this_thread::yield();
    if (m->state.load() != 1) return -1;
    return static_cast<int64_t>(m->raw_size);
}

// Decompress chunk into out (caller sizes it via spl_chunk_raw_size);
// returns raw size, or -1 on IO/corruption (magic, sizes, CRC checked).
int64_t spl_read(void* h, int chunk_id, void* out) {
    auto* s = static_cast<Spiller*>(h);
    std::unique_lock<std::mutex> lk(s->mu);
    if (chunk_id < 0 || chunk_id >= (int)s->chunks.size()) return -1;
    ChunkMeta* m = s->chunks[chunk_id];
    lk.unlock();
    while (m->state.load() == 0) std::this_thread::yield();
    if (m->state.load() != 1) return -1;
    FILE* f = fopen(m->path.c_str(), "rb");
    if (!f) return -1;
    uint32_t magic = 0, crc = 0;
    uint64_t raw = 0, cs = 0;
    bool ok = fread(&magic, 4, 1, f) == 1 && fread(&raw, 8, 1, f) == 1 &&
              fread(&cs, 8, 1, f) == 1 && fread(&crc, 4, 1, f) == 1;
    if (!ok || magic != kMagic || raw != m->raw_size || cs != m->comp_size ||
        raw > (1ull << 40) || cs > (1ull << 40)) {
        fclose(f);
        return -1;
    }
    std::vector<uint8_t> comp(cs);
    ok = cs == 0 || fread(comp.data(), 1, cs, f) == cs;
    fclose(f);
    if (!ok) return -1;
    uLongf got = raw;
    if (uncompress(static_cast<uint8_t*>(out), &got, comp.data(), cs) != Z_OK ||
        got != raw)
        return -1;
    if (crc32(0L, static_cast<uint8_t*>(out), raw) != crc) return -1;
    return static_cast<int64_t>(raw);
}

void spl_stats(void* h, uint64_t* raw, uint64_t* comp) {
    auto* s = static_cast<Spiller*>(h);
    *raw = s->bytes_raw.load();
    *comp = s->bytes_comp.load();
}

// Delete all chunk files and the handle.
void spl_close(void* h, int remove_files) {
    auto* s = static_cast<Spiller*>(h);
    if (remove_files) {
        std::unique_lock<std::mutex> lk(s->mu);
        s->idle_cv.wait(lk, [s] { return s->inflight.load() == 0; });
        for (auto* c : s->chunks) std::remove(c->path.c_str());
    }
    delete s;
}

}  // extern "C"
