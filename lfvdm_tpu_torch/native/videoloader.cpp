// Native video batch loader for lfvdm_tpu.
//
// Role parity: the reference delegates data loading to torch's native
// DataLoader worker pool (reference improved_diffusion/video_datasets.py:64
// wraps datasets in DataLoader(num_workers=...)). This is the TPU
// framework's native equivalent: a C++ thread pool that serves
// (B, T, ...) batches of random frame windows from one-file-per-video
// .npy datasets (MineRL / GQN-mazes layout, SURVEY.md §2.5).
//
// Key IO property: videos are stored frame-major (T, H, W, C), so a random
// T-frame training window is ONE contiguous byte range — workers pread()
// exactly window_bytes instead of deserializing the whole ~50 MB video the
// way the Python path must.
//
// Exposed as a plain C API consumed via ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libvideoloader.so
//        videoloader.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct NpyInfo {
  std::vector<int64_t> shape;
  int64_t header_bytes = 0;   // offset of raw data
  int64_t item_bytes = 0;     // bytes per frame (product of shape[1:]) * dtype
  int dtype = 0;              // 0=uint8, 1=float32
  bool ok = false;
};

// Minimal .npy v1/v2 header parser (C-order, little-endian u1/f4 only).
NpyInfo parse_npy_header(int fd) {
  NpyInfo info;
  unsigned char magic[10];
  if (pread(fd, magic, 10, 0) != 10) return info;
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return info;
  int major = magic[6];
  int64_t hlen, hstart;
  if (major == 1) {
    hlen = magic[8] | (magic[9] << 8);
    hstart = 10;
  } else {
    unsigned char ext[2];
    if (pread(fd, ext, 2, 10) != 2) return info;
    hlen = magic[8] | (magic[9] << 8) | (ext[0] << 16) |
           (static_cast<int64_t>(ext[1]) << 24);
    hstart = 12;
  }
  std::string header(hlen, '\0');
  if (pread(fd, header.data(), hlen, hstart) != hlen) return info;

  if (header.find("'fortran_order': True") != std::string::npos) return info;
  if (header.find("'|u1'") != std::string::npos ||
      header.find("'<u1'") != std::string::npos) {
    info.dtype = 0;
  } else if (header.find("'<f4'") != std::string::npos) {
    info.dtype = 1;
  } else {
    return info;
  }

  auto lp = header.find("'shape': (");
  if (lp == std::string::npos) return info;
  lp += 10;
  auto rp = header.find(')', lp);
  std::string dims = header.substr(lp, rp - lp);
  int64_t v = 0;
  bool in_num = false;
  for (char c : dims) {
    if (c >= '0' && c <= '9') {
      v = v * 10 + (c - '0');
      in_num = true;
    } else if (in_num) {
      info.shape.push_back(v);
      v = 0;
      in_num = false;
    }
  }
  if (in_num) info.shape.push_back(v);
  if (info.shape.empty()) return info;

  int64_t per_frame = (info.dtype == 0 ? 1 : 4);
  for (size_t i = 1; i < info.shape.size(); ++i) per_frame *= info.shape[i];
  info.item_bytes = per_frame;
  info.header_bytes = hstart + hlen;
  info.ok = true;
  return info;
}

struct Batch {
  std::vector<uint8_t> buf;
  bool ok = true;
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<int64_t> lengths;  // frames per video
  NpyInfo proto;                 // shape template from the first file
  int T = 0;
  int batch = 0;
  bool deterministic = false;    // iterate files in order (no shuffle)
  bool test_mode = false;        // window start pinned to 0
  uint64_t seed = 0;

  int64_t batch_bytes = 0;

  // ring of filled batch buffers
  std::queue<Batch> ready;
  size_t capacity = 4;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};

  // work sequencing: one producer thread draws the epoch order and window
  // starts; worker threads fill frames of the current batch in parallel.
  std::vector<std::thread> workers;

  ~Loader() { shutdown(); }

  void shutdown() {
    stop.store(true);
    cv_ready.notify_all();
    cv_space.notify_all();
    for (auto &t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }

  bool read_window(const std::string &path, int64_t start_frame, uint8_t *dst) {
    int fd = open(path.c_str(), O_RDONLY);
    if (fd < 0) return false;
    NpyInfo info = parse_npy_header(fd);
    // Full per-frame shape + dtype must match the prototype — item_bytes
    // alone would let e.g. u8 (T,64,64,3) and f4 (T,32,32,3) alias.
    bool same = info.ok && info.dtype == proto.dtype &&
                info.shape.size() == proto.shape.size();
    if (same) {
      for (size_t i = 1; i < info.shape.size(); ++i) {
        same = same && info.shape[i] == proto.shape[i];
      }
    }
    if (!same) {
      close(fd);
      return false;
    }
    int64_t off = info.header_bytes + start_frame * info.item_bytes;
    int64_t want = static_cast<int64_t>(T) * info.item_bytes;
    int64_t got = 0;
    while (got < want) {
      ssize_t r = pread(fd, dst + got, want - got, off + got);
      if (r <= 0) {
        close(fd);
        return false;
      }
      got += r;
    }
    close(fd);
    return true;
  }

  void producer_loop(int n_threads) {
    std::mt19937_64 rng(seed);
    std::vector<size_t> order(paths.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    int64_t window_bytes = static_cast<int64_t>(T) * proto.item_bytes;

    while (!stop.load()) {
      if (!deterministic) {
        for (size_t i = order.size() - 1; i > 0; --i) {
          std::swap(order[i], order[rng() % (i + 1)]);
        }
      }
      for (size_t b0 = 0; b0 + batch <= order.size() && !stop.load(); b0 += batch) {
        std::vector<uint8_t> buf(batch_bytes);
        std::atomic<int> next{0};
        std::atomic<bool> fail{false};
        std::vector<std::pair<size_t, int64_t>> jobs(batch);
        for (int i = 0; i < batch; ++i) {
          size_t vid = order[b0 + i];
          int64_t max_start = lengths[vid] - T;
          int64_t start =
              (test_mode || max_start <= 0) ? 0 : static_cast<int64_t>(rng() % (max_start + 1));
          jobs[i] = {vid, start};
        }
        auto work = [&]() {
          int i;
          while ((i = next.fetch_add(1)) < batch && !stop.load()) {
            if (!read_window(paths[jobs[i].first], jobs[i].second,
                             buf.data() + static_cast<int64_t>(i) * window_bytes)) {
              fail.store(true);
            }
          }
        };
        std::vector<std::thread> pool;
        int nt = n_threads > batch ? batch : n_threads;
        for (int t = 1; t < nt; ++t) pool.emplace_back(work);
        work();
        for (auto &t : pool) t.join();

        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return ready.size() < capacity || stop.load(); });
        if (stop.load()) return;
        // Failed reads propagate as an error batch; vl_next surfaces them
        // instead of serving silently-zeroed training data.
        ready.push(Batch{std::move(buf), !fail.load()});
        cv_ready.notify_one();
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr on failure.
void *vl_open(const char **paths, int64_t n_paths, int T, int batch,
              int n_threads, int capacity, uint64_t seed, int deterministic,
              int test_mode) {
  // batch > n_paths would make the epoch loop produce zero batches
  // (drop_last semantics) and vl_next block forever — reject at open.
  if (n_paths <= 0 || T <= 0 || batch <= 0 || batch > n_paths) return nullptr;
  auto *L = new Loader();
  L->T = T;
  L->batch = batch;
  L->seed = seed;
  L->deterministic = deterministic != 0;
  L->test_mode = test_mode != 0;
  L->capacity = capacity > 0 ? capacity : 4;
  for (int64_t i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);

  for (auto &p : L->paths) {
    int fd = open(p.c_str(), O_RDONLY);
    if (fd < 0) {
      delete L;
      return nullptr;
    }
    NpyInfo info = parse_npy_header(fd);
    close(fd);
    if (!info.ok || info.shape[0] < T) {
      delete L;
      return nullptr;
    }
    if (L->lengths.empty()) L->proto = info;
    bool same = info.dtype == L->proto.dtype &&
                info.shape.size() == L->proto.shape.size();
    if (same) {
      for (size_t i = 1; i < info.shape.size(); ++i) {
        same = same && info.shape[i] == L->proto.shape[i];
      }
    }
    if (!same) {
      delete L;
      return nullptr;
    }
    L->lengths.push_back(info.shape[0]);
  }
  L->batch_bytes = static_cast<int64_t>(batch) * T * L->proto.item_bytes;
  int nt = n_threads > 0 ? n_threads : 4;
  L->workers.emplace_back([L, nt] { L->producer_loop(nt); });
  return L;
}

// Item metadata: ndim, shape (with shape[0] := T), dtype (0=u8, 1=f32).
int vl_item_info(void *handle, int64_t *shape_out, int *ndim_out, int *dtype_out) {
  auto *L = static_cast<Loader *>(handle);
  if (!L) return -1;
  *ndim_out = static_cast<int>(L->proto.shape.size());
  for (size_t i = 0; i < L->proto.shape.size(); ++i) shape_out[i] = L->proto.shape[i];
  shape_out[0] = L->T;
  *dtype_out = L->proto.dtype;
  return 0;
}

int64_t vl_batch_bytes(void *handle) {
  auto *L = static_cast<Loader *>(handle);
  return L ? L->batch_bytes : -1;
}

// Blocks until a batch is ready; copies it into out. Returns 0 on success,
// -3 if the batch had a failed file read (data invalid).
int vl_next(void *handle, void *out, int64_t out_bytes) {
  auto *L = static_cast<Loader *>(handle);
  if (!L || out_bytes < L->batch_bytes) return -1;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] { return !L->ready.empty() || L->stop.load(); });
  if (L->ready.empty()) return -2;
  Batch b = std::move(L->ready.front());
  L->ready.pop();
  L->cv_space.notify_one();
  lk.unlock();
  if (!b.ok) return -3;
  std::memcpy(out, b.buf.data(), b.buf.size());
  return 0;
}

void vl_close(void *handle) { delete static_cast<Loader *>(handle); }

}  // extern "C"
