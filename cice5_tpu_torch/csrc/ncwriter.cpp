// Asynchronous netCDF-3 (classic) history writer of the PyTorch port
// (a copy of native/fastwriter/ncwriter.cpp, built by
// cice5_tpu_torch/io/fastwriter.py).
//
// The equivalent of the reference's parallel I/O layer (the PIO library
// built in bld/build.sh:57-72 and the io_netcdf/io_pio history backends):
// the model hands off host arrays and continues stepping while a
// background thread serializes records to disk. The classic netCDF format
// is written directly (header + big-endian records), so there is no
// dependency on a netCDF C library.
//
// C ABI (ctypes):
//   h   = ncw_create(path, ny, nx, nvar, names_csv)   -> handle (>0) or <0
//   ok  = ncw_append(h, time, data[nvar*ny*nx] float)  (enqueue; non-block)
//   ok  = ncw_flush(h)          (wait until every record is written)
//   ok  = ncw_close(h)          (flush + finalize)
//   n   = ncw_pending(h)        (records queued or being written)
//
// Unlike the copy in native/, flush waits for the record the worker is
// writing as well as for the queue, and the error flag is atomic.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

void put_be32(std::string &b, uint32_t v) {
  b.push_back(char((v >> 24) & 0xff));
  b.push_back(char((v >> 16) & 0xff));
  b.push_back(char((v >> 8) & 0xff));
  b.push_back(char(v & 0xff));
}

void put_name(std::string &b, const std::string &s) {
  put_be32(b, uint32_t(s.size()));
  b += s;
  while (b.size() % 4) b.push_back('\0');
}

void put_be64f(std::string &b, double v) {
  uint64_t u;
  std::memcpy(&u, &v, 8);
  for (int i = 7; i >= 0; --i) b.push_back(char((u >> (8 * i)) & 0xff));
}

struct Record {
  double time;
  std::vector<float> data;   // nvar * ny * nx
};

struct Writer {
  std::FILE *fp = nullptr;
  int ny = 0, nx = 0, nvar = 0;
  long numrecs_off = 4;      // offset of the numrecs field
  long data_begin = 0;       // offset of record 0
  long rec_size = 0;         // bytes per record (time + all vars)
  uint32_t numrecs = 0;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Record> queue;
  bool stop = false;
  int busy = 0;              // records popped, not yet written
  std::atomic<bool> error{false};

  void write_header(const std::vector<std::string> &names) {
    std::string h;
    h += "CDF";
    h.push_back(1);                       // version 1 (32-bit offsets)
    put_be32(h, 0);                       // numrecs (updated per record)
    // dim_list: NC_DIMENSION = 10
    put_be32(h, 10);
    put_be32(h, 3);
    put_name(h, "time"); put_be32(h, 0);  // record dim
    put_name(h, "nj");   put_be32(h, uint32_t(ny));
    put_name(h, "ni");   put_be32(h, uint32_t(nx));
    // gatt_list: ABSENT
    put_be32(h, 0); put_be32(h, 0);
    // var_list: NC_VARIABLE = 11
    put_be32(h, 11);
    put_be32(h, uint32_t(nvar + 1));
    const long field_bytes = 4L * ny * nx;
    // offsets are filled after we know the header length; reserve with a
    // two-pass build: first compute the variable-entry sizes.
    struct VE { std::string name; int ndims; int type; long vsize; };
    std::vector<VE> ves;
    ves.push_back({"time", 1, 6 /*double*/, 8});
    for (auto &n : names) ves.push_back({n, 3, 5 /*float*/, field_bytes});
    // entry byte size: name + ndims + dimids + ABSENT atts + type + vsize
    auto entry_size = [](const VE &v) {
      long name_sz = 4 + ((v.name.size() + 3) / 4) * 4;
      return name_sz + 4 + 4L * v.ndims + 8 + 4 + 4 + 4;  // +begin(4)
    };
    long header_size = long(h.size());
    for (auto &v : ves) header_size += entry_size(v);
    // record layout: time first, then each field, each padded to 4 (all
    // sizes here are already multiples of 4)
    rec_size = 8 + long(nvar) * field_bytes;
    data_begin = header_size;
    long begin = data_begin;
    for (size_t i = 0; i < ves.size(); ++i) {
      const VE &v = ves[i];
      put_name(h, v.name);
      put_be32(h, uint32_t(v.ndims));
      if (v.ndims == 1) {
        put_be32(h, 0);
      } else {
        put_be32(h, 0); put_be32(h, 1); put_be32(h, 2);
      }
      put_be32(h, 0); put_be32(h, 0);        // vatt_list ABSENT
      put_be32(h, uint32_t(v.type));
      put_be32(h, uint32_t(v.vsize));
      put_be32(h, uint32_t(begin));
      begin += v.vsize;
    }
    std::fwrite(h.data(), 1, h.size(), fp);
    std::fflush(fp);
  }

  void append_record(const Record &r) {
    std::string buf;
    buf.reserve(size_t(rec_size));
    put_be64f(buf, r.time);
    for (float f : r.data) {
      uint32_t u;
      std::memcpy(&u, &f, 4);
      put_be32(buf, u);
    }
    long off = data_begin + long(numrecs) * rec_size;
    if (std::fseek(fp, off, SEEK_SET) != 0) { error = true; return; }
    if (std::fwrite(buf.data(), 1, buf.size(), fp) != buf.size()) {
      error = true; return;
    }
    ++numrecs;
    std::fseek(fp, numrecs_off, SEEK_SET);
    std::string n;
    put_be32(n, numrecs);
    std::fwrite(n.data(), 1, 4, fp);
    std::fflush(fp);
  }

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv.wait(lk, [&] { return stop || !queue.empty(); });
      if (queue.empty() && stop) break;
      Record r = std::move(queue.front());
      queue.pop_front();
      ++busy;
      lk.unlock();
      append_record(r);
      lk.lock();
      --busy;
      cv.notify_all();
    }
  }
};

std::mutex g_mu;
std::map<int, std::unique_ptr<Writer>> g_writers;
int g_next = 1;

}  // namespace

extern "C" {

int ncw_create(const char *path, int ny, int nx, int nvar,
               const char *names_csv) {
  auto w = std::make_unique<Writer>();
  w->fp = std::fopen(path, "wb");
  if (!w->fp) return -1;
  w->ny = ny; w->nx = nx; w->nvar = nvar;
  std::vector<std::string> names;
  std::string cur;
  for (const char *p = names_csv; *p; ++p) {
    if (*p == ',') { names.push_back(cur); cur.clear(); }
    else cur.push_back(*p);
  }
  if (!cur.empty()) names.push_back(cur);
  if (int(names.size()) != nvar) { std::fclose(w->fp); return -2; }
  w->write_header(names);
  Writer *wp = w.get();
  w->worker = std::thread([wp] { wp->run(); });
  std::lock_guard<std::mutex> lk(g_mu);
  int h = g_next++;
  g_writers[h] = std::move(w);
  return h;
}

int ncw_append(int h, double time, const float *data) {
  Writer *w;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_writers.find(h);
    if (it == g_writers.end()) return -1;
    w = it->second.get();
  }
  Record r;
  r.time = time;
  r.data.assign(data, data + size_t(w->nvar) * w->ny * w->nx);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.push_back(std::move(r));
  }
  w->cv.notify_all();
  return w->error ? -2 : 0;
}

int ncw_pending(int h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_writers.find(h);
  if (it == g_writers.end()) return -1;
  std::lock_guard<std::mutex> lk2(it->second->mu);
  return int(it->second->queue.size()) + it->second->busy;
}

int ncw_flush(int h) {
  Writer *w;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_writers.find(h);
    if (it == g_writers.end()) return -1;
    w = it->second.get();
  }
  std::unique_lock<std::mutex> lk(w->mu);
  w->cv.wait(lk, [&] { return w->queue.empty() && w->busy == 0; });
  return w->error ? -2 : 0;
}

int ncw_close(int h) {
  std::unique_ptr<Writer> w;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_writers.find(h);
    if (it == g_writers.end()) return -1;
    w = std::move(it->second);
    g_writers.erase(it);
  }
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->stop = true;
  }
  w->cv.notify_all();
  w->worker.join();
  std::fclose(w->fp);
  return w->error ? -2 : 0;
}

}  // extern "C"
