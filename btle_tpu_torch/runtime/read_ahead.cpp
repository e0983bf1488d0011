// One reader thread for a live loop: it copies the ring's next block
// into rows the caller lends it while the caller's thread works on.
//
// The thread runs no Python, so it never takes the interpreter lock: a
// Python reader thread's wake-up and lock handoffs cost the loop about as
// much host time a block as the copy it hides. The read itself is
// runtime.cpp's iq_ring_read_block, passed in as a function pointer, so
// runtime.cpp stays the JAX package's copy.
//
// One request at a time: submit, then wait (which returns the read's
// result), then submit again. close waits for a read in flight and joins
// the thread.

#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <thread>

namespace {

using ReadBlock = uint64_t (*)(void*, int16_t*, int16_t*, size_t, size_t);

enum class State { kIdle, kAsked, kDone, kQuit };

struct ReadAhead {
    ReadBlock read;
    void* ring;
    size_t scan_len, halo;
    std::mutex mu;
    std::condition_variable cv;
    State state = State::kIdle;
    int16_t* i_out = nullptr;
    int16_t* q_out = nullptr;
    uint64_t got = 0;
    std::thread thread;

    void loop() {
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
            cv.wait(lk, [&] { return state == State::kAsked || state == State::kQuit; });
            if (state == State::kQuit) return;
            lk.unlock();
            uint64_t n = read(ring, i_out, q_out, scan_len, halo);
            lk.lock();
            got = n;
            state = State::kDone;
            cv.notify_all();
        }
    }
};

int g_open = 0;          // readers opened and not yet closed
std::mutex g_open_mu;

}  // namespace

extern "C" {

// nullptr when the thread cannot be started
void* read_ahead_open(void* read_block, void* ring, size_t scan_len, size_t halo) {
    ReadAhead* r = nullptr;
    try {
        r = new ReadAhead();
        r->read = reinterpret_cast<ReadBlock>(read_block);
        r->ring = ring;
        r->scan_len = scan_len;
        r->halo = halo;
        r->thread = std::thread([r] { r->loop(); });
    } catch (...) {
        delete r;
        return nullptr;
    }
    std::lock_guard<std::mutex> g(g_open_mu);
    ++g_open;
    return r;
}

void read_ahead_submit(void* p, int16_t* i_out, int16_t* q_out) {
    auto* r = static_cast<ReadAhead*>(p);
    std::lock_guard<std::mutex> lk(r->mu);
    r->i_out = i_out;
    r->q_out = q_out;
    r->state = State::kAsked;
    r->cv.notify_all();
}

int read_ahead_done(void* p) {
    auto* r = static_cast<ReadAhead*>(p);
    std::lock_guard<std::mutex> lk(r->mu);
    return r->state == State::kDone;
}

uint64_t read_ahead_wait(void* p) {
    auto* r = static_cast<ReadAhead*>(p);
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv.wait(lk, [&] { return r->state == State::kDone; });
    r->state = State::kIdle;
    return r->got;
}

void read_ahead_close(void* p) {
    auto* r = static_cast<ReadAhead*>(p);
    {
        std::unique_lock<std::mutex> lk(r->mu);
        r->cv.wait(lk, [&] { return r->state != State::kAsked; });
        r->state = State::kQuit;
        r->cv.notify_all();
    }
    r->thread.join();
    delete r;
    std::lock_guard<std::mutex> g(g_open_mu);
    --g_open;
}

int read_ahead_open_count() {
    std::lock_guard<std::mutex> g(g_open_mu);
    return g_open;
}

}  // extern "C"
