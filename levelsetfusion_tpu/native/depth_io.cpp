// Native depth-image IO + threaded dataset prefetcher.
//
// The reference's only native component is a C++ optimization module
// (SURVEY.md §2.15); in this build the compute path is XLA, and the
// host-side component that genuinely benefits from
// native code is the data path: decoding 16-bit depth PNGs (libpng) and
// prefetching frames ahead of the device pipeline (std::thread pool with a
// bounded queue), so TSDF generation never stalls on disk/decode.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: see build.sh (g++ -O3 -shared -fPIC depth_io.cpp -lpng -lz).

#include <png.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 16-bit (or 8-bit) grayscale PNG decode.
// Returns 0 on success. Two-phase: query dims, then decode into caller buf.
// ---------------------------------------------------------------------------

int lsf_png_info(const char* path, int* width, int* height, int* bit_depth) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *width = png_get_image_width(png, info);
  *height = png_get_image_height(png, info);
  *bit_depth = png_get_bit_depth(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

// Decodes into out (uint16, row-major, width*height elements). Color images
// are reduced to their first channel; 8-bit values are widened.
int lsf_load_depth_png(const char* path, uint16_t* out, int width, int height) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  const int w = png_get_image_width(png, info);
  const int h = png_get_image_height(png, info);
  if (w != width || h != height) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -3;
  }
  const int bit_depth = png_get_bit_depth(png, info);
  const int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  png_read_update_info(png, info);
  const int channels = png_get_channels(png, info);
  const size_t rowbytes = png_get_rowbytes(png, info);

  std::vector<uint8_t> row(rowbytes);
  for (int y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    uint16_t* dst = out + static_cast<size_t>(y) * w;
    if (bit_depth == 16) {
      // PNG 16-bit is big-endian.
      for (int x = 0; x < w; ++x) {
        const uint8_t* px = row.data() + static_cast<size_t>(x) * channels * 2;
        dst[x] = static_cast<uint16_t>((px[0] << 8) | px[1]);
      }
    } else {
      for (int x = 0; x < w; ++x) {
        dst[x] = row[static_cast<size_t>(x) * channels];
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded prefetcher: decodes a fixed list of frames ahead of consumption,
// preserving order, with a bounded number of in-flight decodes.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  int width = 0, height = 0;
  size_t next_submit = 0;
  size_t next_consume = 0;
  size_t max_inflight = 4;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;
  struct Slot {
    std::vector<uint16_t> data;
    int status = 1;  // 1 = pending, 0 = ok, <0 = error
    bool done = false;
  };
  std::deque<std::unique_ptr<Slot>> slots;  // slot i = frame next_consume + i
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      size_t idx;
      Slot* slot;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] {
          return stop || (next_submit < paths.size() &&
                          next_submit - next_consume < max_inflight);
        });
        if (stop) return;
        idx = next_submit++;
        while (slots.size() <= idx - next_consume)
          slots.emplace_back(new Slot());
        slot = slots[idx - next_consume].get();
      }
      std::vector<uint16_t> buf(static_cast<size_t>(width) * height);
      int rc = lsf_load_depth_png(paths[idx].c_str(), buf.data(), width, height);
      {
        // `slot` stays valid: the deque holds unique_ptrs (stable targets)
        // and a slot is only popped once marked done, in order.
        std::unique_lock<std::mutex> lock(mu);
        slot->data = std::move(buf);
        slot->status = rc;
        slot->done = true;
        cv.notify_all();
      }
    }
  }
};

void* lsf_prefetcher_create(const char** paths, int n, int width, int height,
                            int num_threads, int max_inflight) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->width = width;
  p->height = height;
  p->max_inflight = max_inflight > 0 ? max_inflight : 4;
  const int nt = num_threads > 0 ? num_threads : 2;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocks until the next frame (in order) is decoded; copies into out.
// Returns the decode status (0 ok), or -100 if past the end.
int lsf_prefetcher_next(void* handle, uint16_t* out) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lock(p->mu);
  if (p->next_consume >= p->paths.size()) return -100;
  p->cv.notify_all();
  p->cv.wait(lock, [&] {
    return !p->slots.empty() && p->slots.front()->done;
  });
  auto slot = std::move(p->slots.front());
  p->slots.pop_front();
  p->next_consume++;
  p->cv.notify_all();
  if (slot->status == 0)
    std::memcpy(out, slot->data.data(), slot->data.size() * sizeof(uint16_t));
  return slot->status;
}

void lsf_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::unique_lock<std::mutex> lock(p->mu);
    p->stop = true;
    p->cv.notify_all();
  }
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
