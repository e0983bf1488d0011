// btle_tpu native runtime: sample transport between IO and the device.
//
// TPU-native counterpart of the reference's L1 layer (SURVEY.md):
//   * a lock-free single-producer/single-consumer IQ ring buffer — the
//     rx_buf + volatile offset design of btle_rx.c:221-248 made explicit
//     with C++11 atomics (no benign-data-race idiom),
//   * overlap-save block extraction (the half-buffer + tail-copy scan of
//     btle_rx.c:2619-2637): the consumer takes scan_len+halo samples but
//     advances by scan_len,
//   * wire-format deinterleavers (int8 HackRF / int16 firmware / float32
//     usrp-replay) feeding pinned host arrays for device transfer,
//   * a UDP listener thread — the board->host packet transport that the
//     FPGA path implements with raw Ethernet (firmware/btle_ll.c:183-282).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -o libbtleruntime.so runtime.cpp -lpthread

#include <atomic>
#include <vector>
#include <cstdint>
#include <cstring>
#include <thread>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

struct IqRing {
    int16_t* i_buf;
    int16_t* q_buf;
    size_t capacity;                 // power of two, in IQ pairs
    size_t mask;
    std::atomic<uint64_t> wr{0};     // total pairs written
    std::atomic<uint64_t> rd{0};     // total pairs consumed
    std::atomic<uint64_t> dropped{0};
};

inline size_t round_pow2(size_t v) {
    size_t p = 1;
    while (p < v) p <<= 1;
    return p;
}

}  // namespace

extern "C" {

IqRing* iq_ring_create(size_t capacity_pairs) {
    auto* r = new IqRing();
    r->capacity = round_pow2(capacity_pairs);
    r->mask = r->capacity - 1;
    r->i_buf = new int16_t[r->capacity];
    r->q_buf = new int16_t[r->capacity];
    return r;
}

void iq_ring_destroy(IqRing* r) {
    delete[] r->i_buf;
    delete[] r->q_buf;
    delete r;
}

uint64_t iq_ring_available(IqRing* r) {
    return r->wr.load(std::memory_order_acquire) - r->rd.load(std::memory_order_acquire);
}

uint64_t iq_ring_dropped(IqRing* r) { return r->dropped.load(std::memory_order_relaxed); }
uint64_t iq_ring_total_written(IqRing* r) { return r->wr.load(std::memory_order_relaxed); }

// Generic write of deinterleaved pairs. Drops (counts) when full.
// Copies are split at the wrap point into (at most two) contiguous
// memcpys — per-element masked indexing defeats vectorization and caps
// the ring ~3x BELOW the 80 Msps wideband rate (measured).
static uint64_t ring_write(IqRing* r, const int16_t* i_in, const int16_t* q_in, size_t n) {
    uint64_t wr = r->wr.load(std::memory_order_relaxed);
    uint64_t rd = r->rd.load(std::memory_order_acquire);
    size_t space = r->capacity - (size_t)(wr - rd);
    if (n > space) {
        r->dropped.fetch_add(n - space, std::memory_order_relaxed);
        n = space;
    }
    size_t at = (size_t)wr & r->mask;
    size_t first = r->capacity - at;
    if (first > n) first = n;
    memcpy(r->i_buf + at, i_in, first * sizeof(int16_t));
    memcpy(r->q_buf + at, q_in, first * sizeof(int16_t));
    if (n > first) {
        memcpy(r->i_buf, i_in + first, (n - first) * sizeof(int16_t));
        memcpy(r->q_buf, q_in + first, (n - first) * sizeof(int16_t));
    }
    r->wr.store(wr + n, std::memory_order_release);
    return n;
}

// Contiguous (wrap-split) copy out of the ring starting at absolute
// position `from`, n pairs.
static void ring_copy_out(IqRing* r, uint64_t from, int16_t* i_out,
                          int16_t* q_out, size_t n) {
    size_t at = (size_t)from & r->mask;
    size_t first = r->capacity - at;
    if (first > n) first = n;
    memcpy(i_out, r->i_buf + at, first * sizeof(int16_t));
    memcpy(q_out, r->q_buf + at, first * sizeof(int16_t));
    if (n > first) {
        memcpy(i_out + first, r->i_buf, (n - first) * sizeof(int16_t));
        memcpy(q_out + first, r->q_buf, (n - first) * sizeof(int16_t));
    }
}

uint64_t iq_ring_write_i8(IqRing* r, const int8_t* interleaved, size_t n_pairs) {
    // convert + write in chunks to bound stack usage
    int16_t ti[4096], tq[4096];
    uint64_t written = 0;
    while (n_pairs) {
        size_t c = n_pairs < 4096 ? n_pairs : 4096;
        for (size_t k = 0; k < c; k++) {
            ti[k] = interleaved[2 * k];
            tq[k] = interleaved[2 * k + 1];
        }
        uint64_t w = ring_write(r, ti, tq, c);
        written += w;
        if (w < c) break;
        interleaved += 2 * c;
        n_pairs -= c;
    }
    return written;
}

uint64_t iq_ring_write_i16(IqRing* r, const int16_t* interleaved, size_t n_pairs) {
    int16_t ti[4096], tq[4096];
    uint64_t written = 0;
    while (n_pairs) {
        size_t c = n_pairs < 4096 ? n_pairs : 4096;
        for (size_t k = 0; k < c; k++) {
            ti[k] = interleaved[2 * k];
            tq[k] = interleaved[2 * k + 1];
        }
        uint64_t w = ring_write(r, ti, tq, c);
        written += w;
        if (w < c) break;
        interleaved += 2 * c;
        n_pairs -= c;
    }
    return written;
}

uint64_t iq_ring_write_f32(IqRing* r, const float* interleaved, size_t n_pairs, float scale) {
    int16_t ti[4096], tq[4096];
    uint64_t written = 0;
    while (n_pairs) {
        size_t c = n_pairs < 4096 ? n_pairs : 4096;
        for (size_t k = 0; k < c; k++) {
            float a = interleaved[2 * k] * scale;
            float b = interleaved[2 * k + 1] * scale;
            ti[k] = (int16_t)(a < 0 ? a - 0.5f : a + 0.5f);
            tq[k] = (int16_t)(b < 0 ? b - 0.5f : b + 0.5f);
        }
        uint64_t w = ring_write(r, ti, tq, c);
        written += w;
        if (w < c) break;
        interleaved += 2 * c;
        n_pairs -= c;
    }
    return written;
}

// Overlap-save block read: copies scan_len+halo pairs into i_out/q_out but
// only consumes scan_len. Returns 0 when not enough data is buffered.
uint64_t iq_ring_read_block(IqRing* r, int16_t* i_out, int16_t* q_out,
                            size_t scan_len, size_t halo) {
    size_t need = scan_len + halo;
    uint64_t rd = r->rd.load(std::memory_order_relaxed);
    uint64_t wr = r->wr.load(std::memory_order_acquire);
    if ((size_t)(wr - rd) < need) return 0;
    ring_copy_out(r, rd, i_out, q_out, need);
    r->rd.store(rd + scan_len, std::memory_order_release);
    return need;
}

// Drain everything left (final partial block). Consumes all.
uint64_t iq_ring_drain(IqRing* r, int16_t* i_out, int16_t* q_out, size_t max_pairs) {
    uint64_t rd = r->rd.load(std::memory_order_relaxed);
    uint64_t wr = r->wr.load(std::memory_order_acquire);
    size_t n = (size_t)(wr - rd);
    if (n > max_pairs) n = max_pairs;
    ring_copy_out(r, rd, i_out, q_out, n);
    r->rd.store(rd + n, std::memory_order_release);
    return n;
}

// ---------------- standalone deinterleavers ----------------

void deinterleave_i8(const int8_t* in, size_t n_pairs, int16_t* i, int16_t* q) {
    for (size_t k = 0; k < n_pairs; k++) {
        i[k] = in[2 * k];
        q[k] = in[2 * k + 1];
    }
}

void deinterleave_i16(const int16_t* in, size_t n_pairs, int16_t* i, int16_t* q) {
    for (size_t k = 0; k < n_pairs; k++) {
        i[k] = in[2 * k];
        q[k] = in[2 * k + 1];
    }
}

void deinterleave_f32(const float* in, size_t n_pairs, float scale, int16_t* i, int16_t* q) {
    for (size_t k = 0; k < n_pairs; k++) {
        float a = in[2 * k] * scale;
        float b = in[2 * k + 1] * scale;
        i[k] = (int16_t)(a < 0 ? a - 0.5f : a + 0.5f);
        q[k] = (int16_t)(b < 0 ? b - 0.5f : b + 0.5f);
    }
}

// ---------------- UDP ingest thread ----------------
// Datagrams carry interleaved samples; fmt: 0=int8, 1=int16, 2=float32.

struct UdpSource {
    int fd = -1;
    std::thread th;
    std::atomic<bool> stop{false};
    std::atomic<uint64_t> datagrams{0};
    IqRing* ring = nullptr;
    int fmt = 1;
};

UdpSource* udp_source_start(IqRing* ring, uint16_t port, int fmt) {
    auto* s = new UdpSource();
    s->ring = ring;
    s->fmt = fmt;
    s->fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (s->fd < 0) {
        delete s;
        return nullptr;
    }
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(port);
    if (bind(s->fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
        close(s->fd);
        delete s;
        return nullptr;
    }
    timeval tv{0, 100000};  // 100 ms poll so stop is responsive
    setsockopt(s->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    s->th = std::thread([s] {
        std::vector<uint8_t> buf(65536);
        while (!s->stop.load(std::memory_order_relaxed)) {
            ssize_t n = recv(s->fd, buf.data(), buf.size(), 0);
            if (n <= 0) continue;
            s->datagrams.fetch_add(1, std::memory_order_relaxed);
            if (s->fmt == 0)
                iq_ring_write_i8(s->ring, (const int8_t*)buf.data(), (size_t)n / 2);
            else if (s->fmt == 1)
                iq_ring_write_i16(s->ring, (const int16_t*)buf.data(), (size_t)n / 4);
            else
                iq_ring_write_f32(s->ring, (const float*)buf.data(), (size_t)n / 8, 256.0f);
        }
    });
    return s;
}

uint64_t udp_source_datagrams(UdpSource* s) { return s->datagrams.load(); }

void udp_source_stop(UdpSource* s) {
    s->stop.store(true);
    if (s->th.joinable()) s->th.join();
    close(s->fd);
    delete s;
}

}  // extern "C"
