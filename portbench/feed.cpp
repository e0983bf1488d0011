// The wideband cells' sample feed: a native thread that writes the
// looped scene into the program's int16 IQ ring through the ring's own
// C entry point, closed loop (whenever the ring has room for a whole
// write, so it never overruns) or paced (each write when its last
// sample is due). A native thread, like the program's UDP ingest, so
// the feed never waits for the interpreter lock the sniffer holds.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -pthread (portbench/feed.py).

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <ctime>
#include <thread>

namespace {

typedef uint64_t (*write_fn)(void*, const int16_t*, size_t);
typedef uint64_t (*avail_fn)(void*);

double now_s() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);   // the clock of time.perf_counter
    return ts.tv_sec + ts.tv_nsec * 1e-9;
}

void sleep_until(double t) {
    timespec ts;
    ts.tv_sec = (time_t)t;
    ts.tv_nsec = (long)((t - (double)ts.tv_sec) * 1e9);
    if (ts.tv_nsec >= 1000000000L) { ts.tv_sec += 1; ts.tv_nsec -= 1000000000L; }
    while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &ts, nullptr) != 0) {
    }
}

struct Feed {
    void* ring;
    write_fn write;
    avail_fn avail;
    const int16_t* iq;          // interleaved I/Q of the scene
    uint64_t n_scene;           // pairs
    uint64_t write_pairs;
    double pairs_per_s;         // 0: closed loop
    uint64_t capacity;          // the ring's, in pairs
    double t0;
    uint64_t max_rec;
    std::atomic<uint64_t> n_rec{0};
    int64_t* rec_gen;           // first generated pair of each write
    int64_t* rec_took;          // pairs the ring took
    double* rec_due;            // due time (NaN in closed loop)
    double* rec_done;           // time the write returned
    std::atomic<int> stop{0};
    std::thread th;

    void run() {
        uint64_t gen = 0;
        const uint64_t n = write_pairs;
        while (!stop.load(std::memory_order_relaxed)) {
            const uint64_t r = n_rec.load(std::memory_order_relaxed);
            if (r >= max_rec) break;
            double due = __builtin_nan("");
            if (pairs_per_s > 0) {
                due = t0 + (double)(gen + n) / pairs_per_s;
                if (now_s() < due) sleep_until(due);
            } else if (capacity - avail(ring) < n) {
                timespec ts{0, 200000};
                nanosleep(&ts, nullptr);
                continue;
            }
            uint64_t took = 0, pos = gen % n_scene, left = n;
            while (left) {
                uint64_t k = left < n_scene - pos ? left : n_scene - pos;
                took += write(ring, iq + 2 * pos, k);
                pos = (pos + k) % n_scene;
                left -= k;
            }
            rec_gen[r] = (int64_t)gen;
            rec_took[r] = (int64_t)took;
            rec_due[r] = due;
            rec_done[r] = now_s();
            n_rec.store(r + 1, std::memory_order_release);
            gen += n;
        }
    }
};

}  // namespace

extern "C" {

void* feed_start(void* ring, void* write, void* avail, const int16_t* iq,
                 uint64_t n_scene, uint64_t write_pairs, double pairs_per_s,
                 uint64_t capacity, double t0, uint64_t max_rec,
                 int64_t* rec_gen, int64_t* rec_took, double* rec_due,
                 double* rec_done) {
    Feed* f = new Feed();
    f->ring = ring;
    f->write = (write_fn)write;
    f->avail = (avail_fn)avail;
    f->iq = iq;
    f->n_scene = n_scene;
    f->write_pairs = write_pairs;
    f->pairs_per_s = pairs_per_s;
    f->capacity = capacity;
    f->t0 = t0;
    f->max_rec = max_rec;
    f->rec_gen = rec_gen;
    f->rec_took = rec_took;
    f->rec_due = rec_due;
    f->rec_done = rec_done;
    f->th = std::thread([f] { f->run(); });
    return f;
}

double feed_now(void) { return now_s(); }

// Stops and joins the thread, frees it; returns the writes recorded.
uint64_t feed_stop(void* p) {
    Feed* f = (Feed*)p;
    f->stop.store(1);
    f->th.join();
    uint64_t n = f->n_rec.load();
    delete f;
    return n;
}

}  // extern "C"
