// Native frame sink: threaded PNG encode + write, decoupled from the render loop.
//
// The reference's presentation path is native (swapchain Present + fence,
// reference: source/main.cpp:337-341); this renderer's equivalent "display" is
// persisting/streaming frames off the host.  Encoding PNGs in the Python loop would
// serialize against render dispatch, so this C++ sink owns a bounded ring of frame
// buffers and a worker pool: the render loop memcpys a frame in (blocking only when
// the ring is full — the same backpressure rule as the reference's fence wait at
// main.cpp:167-171) and workers deflate + write in the background.
//
// C ABI, bound from Python via ctypes (runtime/native_sink.py).  PNG container
// written directly (IHDR/IDAT/IEND); compression via zlib.

#include <zlib.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> data;
  int64_t index = -1;
};

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xFF);
  out.push_back((v >> 16) & 0xFF);
  out.push_back((v >> 8) & 0xFF);
  out.push_back(v & 0xFF);
}

void put_chunk(std::vector<uint8_t>& out, const char tag[4],
               const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t tag_at = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out.data() + tag_at, (uInt)(4 + len));
  put_be32(out, crc);
}

bool encode_png(const uint8_t* pixels, int w, int h, int c,
                std::vector<uint8_t>& out) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  out.assign(sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xFF; ihdr[1] = (w >> 16) & 0xFF;
  ihdr[2] = (w >> 8) & 0xFF;  ihdr[3] = w & 0xFF;
  ihdr[4] = (h >> 24) & 0xFF; ihdr[5] = (h >> 16) & 0xFF;
  ihdr[6] = (h >> 8) & 0xFF;  ihdr[7] = h & 0xFF;
  ihdr[8] = 8;  // bit depth
  ihdr[9] = (c == 1) ? 0 : (c == 3 ? 2 : 6);  // gray / rgb / rgba
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);

  // Raw scanlines with filter byte 0.
  const size_t stride = (size_t)w * c;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;
    memcpy(&raw[y * (stride + 1) + 1], pixels + y * stride, stride);
  }

  uLongf bound = compressBound((uLong)raw.size());
  std::vector<uint8_t> deflated(bound);
  if (compress2(deflated.data(), &bound, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return false;
  put_chunk(out, "IDAT", deflated.data(), bound);
  put_chunk(out, "IEND", nullptr, 0);
  return true;
}

struct Sink {
  std::string out_dir;
  int width, height, channels;
  size_t depth;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop, cv_done;
  std::queue<Frame> queue;
  bool closing = false;
  int64_t pending = 0;  // queued + currently encoding (guarded by mu)
  std::atomic<int64_t> written{0};
  std::atomic<int64_t> errors{0};
  std::vector<std::thread> workers;

  void finish_one() {
    std::lock_guard<std::mutex> lk(mu);
    --pending;
    cv_done.notify_all();
  }

  void worker() {
    for (;;) {
      Frame f;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_pop.wait(lk, [&] { return closing || !queue.empty(); });
        if (queue.empty()) {
          if (closing) return;
          continue;
        }
        f = std::move(queue.front());
        queue.pop();
        cv_push.notify_all();
      }
      // Nothing may unwind out of a thread entry (std::terminate) — a
      // bad_alloc in the encode buffers under memory pressure must take the
      // designed graceful path (++errors) like any other per-frame failure.
      try {
        std::vector<uint8_t> png;
        char path[4096];
        snprintf(path, sizeof(path), "%s/frame_%05lld.png", out_dir.c_str(),
                 (long long)f.index);
        if (!encode_png(f.data.data(), width, height, channels, png)) {
          ++errors;
          finish_one();
          continue;
        }
        FILE* fp = fopen(path, "wb");
        if (!fp) {
          ++errors;
          finish_one();
          continue;
        }
        fwrite(png.data(), 1, png.size(), fp);
        fclose(fp);
        ++written;
      } catch (...) {
        ++errors;
      }
      finish_one();
    }
  }
};

}  // namespace

extern "C" {

void* framesink_create(const char* out_dir, int width, int height, int channels,
                       int queue_depth, int num_threads) {
  // Only gray/RGB/RGBA map to a valid PNG color type; anything else would
  // write an IHDR that disagrees with the IDAT payload (a corrupt file).
  if (!out_dir || width <= 0 || height <= 0 ||
      (channels != 1 && channels != 3 && channels != 4))
    return nullptr;
  auto* s = new Sink();
  s->out_dir = out_dir;
  s->width = width;
  s->height = height;
  s->channels = channels;
  s->depth = (size_t)(queue_depth > 0 ? queue_depth : 3);
  int n = num_threads > 0 ? num_threads : 2;
  for (int i = 0; i < n; ++i) s->workers.emplace_back(&Sink::worker, s);
  return s;
}

// Copies the frame in; blocks while the ring is full (bounded backpressure).
// Returns 0 ok, -1 closing, -2 allocation failure.  No exception may unwind
// across the C ABI into ctypes (undefined behavior) — a bad_alloc on the
// frame copy reports through the error counter instead.
int framesink_push(void* h, const uint8_t* pixels, int64_t index) {
  auto* s = (Sink*)h;
  try {
    Frame f;
    f.index = index;
    f.data.assign(pixels,
                  pixels + (size_t)s->width * s->height * s->channels);
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_push.wait(lk, [&] { return s->closing || s->queue.size() < s->depth; });
    if (s->closing) return -1;
    s->queue.push(std::move(f));
    ++s->pending;
    s->cv_pop.notify_one();
    return 0;
  } catch (...) {
    ++s->errors;
    return -2;
  }
}

// Blocks until every pushed frame is on disk (or failed).
void framesink_flush(void* h) {
  auto* s = (Sink*)h;
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_done.wait(lk, [&] { return s->pending == 0; });
}

int64_t framesink_frames_written(void* h) { return ((Sink*)h)->written.load(); }
int64_t framesink_errors(void* h) { return ((Sink*)h)->errors.load(); }

void framesink_destroy(void* h) {
  auto* s = (Sink*)h;
  framesink_flush(s);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closing = true;
  }
  s->cv_pop.notify_all();
  s->cv_push.notify_all();
  for (auto& t : s->workers) t.join();
  delete s;
}

}  // extern "C"
