// Native runtime for the SLAM pipeline: bounded queues, approximate-time
// stream pairing, and a tracing ring buffer.
//
// The reference's runtime layer is ROS 2 middleware in C++ (DDS pub/sub with
// QoS depth 30, message_filters::ApproximateTime, rclcpp executors —
// frontend.cpp:178-187, backend.cpp:177-190).  This library provides the
// same facilities natively for the in-process pipeline: host threads decode/
// feed frames through these structures while the Python layer dispatches the
// device programs.  Exposed through a plain C ABI for ctypes.
//
// Build: python -m dynamic_visual_slam_tpu_torch.native.build  (g++ -O2 -shared)
//
// The reference package's source plus <cmath> and <algorithm>, which
// declare std::abs(double) and std::min: GCC 13's libstdc++ does not pull
// them in through the other headers (GCC 12's does).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double now_seconds() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// Bounded byte-payload queue (QoS history: drop-oldest), thread-safe.
// ---------------------------------------------------------------------------
struct Item {
  double stamp;
  std::vector<uint8_t> payload;
};

struct Queue {
  explicit Queue(size_t depth) : depth_(depth) {}

  void push(double stamp, const uint8_t* data, size_t len) {
    std::unique_lock<std::mutex> lk(mu_);
    if (q_.size() == depth_) {
      q_.pop_front();
      ++dropped_;
    }
    q_.push_back(Item{stamp, std::vector<uint8_t>(data, data + len)});
    cv_.notify_one();
  }

  // Returns payload length, or -1 on timeout / closed-and-empty.
  int64_t pop(double timeout_s, double* stamp, uint8_t* out, size_t cap) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!cv_.wait_for(lk, std::chrono::duration<double>(timeout_s),
                      [&] { return !q_.empty() || closed_; })) {
      return -1;
    }
    if (q_.empty()) return -1;
    Item it = std::move(q_.front());
    q_.pop_front();
    *stamp = it.stamp;
    size_t n = std::min(cap, it.payload.size());
    std::memcpy(out, it.payload.data(), n);
    return static_cast<int64_t>(it.payload.size());
  }

  void close() {
    std::unique_lock<std::mutex> lk(mu_);
    closed_ = true;
    cv_.notify_all();
  }

  size_t size() {
    std::unique_lock<std::mutex> lk(mu_);
    return q_.size();
  }

  size_t depth_;
  std::deque<Item> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  uint64_t dropped_ = 0;
  bool closed_ = false;
};

// ---------------------------------------------------------------------------
// Two-stream approximate-time synchronizer (message_filters policy).
// Streams hold (stamp, id) pairs; payloads stay with the caller.
// ---------------------------------------------------------------------------
struct SyncPair {
  double stamp_a;
  int64_t id_a;
  int64_t id_b;  // -1 when emitted without a match (optional stream)
};

struct Synchronizer {
  Synchronizer(size_t queue_size, double slop, bool b_optional,
               int timeout_entries)
      : queue_size_(queue_size),
        slop_(slop),
        b_optional_(b_optional),
        timeout_entries_(timeout_entries) {}

  void push_a(double stamp, int64_t id) {
    std::unique_lock<std::mutex> lk(mu_);
    if (a_.size() == queue_size_) a_.pop_front();
    a_.push_back({stamp, id});
    match(lk);
  }
  void push_b(double stamp, int64_t id) {
    std::unique_lock<std::mutex> lk(mu_);
    if (b_.size() == queue_size_) b_.pop_front();
    b_.push_back({stamp, id});
    match(lk);
  }

  // Drains up to `cap` matched pairs into out; returns count.
  int64_t poll(SyncPair* out, int64_t cap) {
    std::unique_lock<std::mutex> lk(mu_);
    int64_t n = 0;
    while (n < cap && !ready_.empty()) {
      out[n++] = ready_.front();
      ready_.pop_front();
    }
    return n;
  }

 private:
  struct Entry {
    double stamp;
    int64_t id;
  };

  void match(std::unique_lock<std::mutex>&) {
    while (!a_.empty()) {
      const Entry a = a_.front();
      int best = -1;
      double best_dt = slop_;
      for (size_t j = 0; j < b_.size(); ++j) {
        double dt = std::abs(b_[j].stamp - a.stamp);
        if (dt <= best_dt) {
          best = static_cast<int>(j);
          best_dt = dt;
        }
      }
      if (best >= 0) {
        ready_.push_back({a.stamp, a.id, b_[best].id});
        b_.erase(b_.begin(), b_.begin() + best + 1);
        a_.pop_front();
        continue;
      }
      bool b_passed = !b_.empty() && b_.back().stamp > a.stamp + slop_;
      if (b_optional_ &&
          (b_passed ||
           a_.size() > static_cast<size_t>(timeout_entries_))) {
        ready_.push_back({a.stamp, a.id, -1});
        a_.pop_front();
        continue;
      }
      break;
    }
  }

  size_t queue_size_;
  double slop_;
  bool b_optional_;
  int timeout_entries_;
  std::deque<Entry> a_, b_;
  std::deque<SyncPair> ready_;
  std::mutex mu_;
};

// ---------------------------------------------------------------------------
// Trace ring buffer (the reference has only ad-hoc std::chrono logging,
// backend.cpp:953-963; this is a real tracer: fixed-slot begin/end events
// dumped as chrome://tracing JSON by the Python side).
// ---------------------------------------------------------------------------
struct TraceEvent {
  double t;
  int32_t kind;  // 0=begin, 1=end, 2=instant
  int32_t tid;
  char name[48];
};

struct Tracer {
  explicit Tracer(size_t capacity) : events_(capacity) {}

  void record(int kind, int tid, const char* name) {
    uint64_t i = head_.fetch_add(1, std::memory_order_relaxed);
    TraceEvent& e = events_[i % events_.size()];
    e.t = now_seconds();
    e.kind = kind;
    e.tid = tid;
    std::strncpy(e.name, name, sizeof(e.name) - 1);
    e.name[sizeof(e.name) - 1] = 0;
  }

  int64_t dump(TraceEvent* out, int64_t cap) {
    uint64_t n = std::min<uint64_t>(head_.load(), events_.size());
    n = std::min<uint64_t>(n, static_cast<uint64_t>(cap));
    std::memcpy(out, events_.data(), n * sizeof(TraceEvent));
    return static_cast<int64_t>(n);
  }

  std::vector<TraceEvent> events_;
  std::atomic<uint64_t> head_{0};
};

}  // namespace

extern "C" {

// --- queue ---
void* dvs_queue_create(uint64_t depth) { return new Queue(depth); }
void dvs_queue_destroy(void* q) { delete static_cast<Queue*>(q); }
void dvs_queue_push(void* q, double stamp, const uint8_t* data, uint64_t len) {
  static_cast<Queue*>(q)->push(stamp, data, len);
}
int64_t dvs_queue_pop(void* q, double timeout_s, double* stamp, uint8_t* out,
                      uint64_t cap) {
  return static_cast<Queue*>(q)->pop(timeout_s, stamp, out, cap);
}
uint64_t dvs_queue_size(void* q) { return static_cast<Queue*>(q)->size(); }
uint64_t dvs_queue_dropped(void* q) { return static_cast<Queue*>(q)->dropped_; }
void dvs_queue_close(void* q) { static_cast<Queue*>(q)->close(); }

// --- synchronizer ---
void* dvs_sync_create(uint64_t queue_size, double slop, int b_optional,
                      int timeout_entries) {
  return new Synchronizer(queue_size, slop, b_optional != 0, timeout_entries);
}
void dvs_sync_destroy(void* s) { delete static_cast<Synchronizer*>(s); }
void dvs_sync_push_a(void* s, double stamp, int64_t id) {
  static_cast<Synchronizer*>(s)->push_a(stamp, id);
}
void dvs_sync_push_b(void* s, double stamp, int64_t id) {
  static_cast<Synchronizer*>(s)->push_b(stamp, id);
}
int64_t dvs_sync_poll(void* s, SyncPair* out, int64_t cap) {
  return static_cast<Synchronizer*>(s)->poll(out, cap);
}

// --- tracer ---
void* dvs_trace_create(uint64_t capacity) { return new Tracer(capacity); }
void dvs_trace_destroy(void* t) { delete static_cast<Tracer*>(t); }
void dvs_trace_record(void* t, int kind, int tid, const char* name) {
  static_cast<Tracer*>(t)->record(kind, tid, name);
}
int64_t dvs_trace_dump(void* t, TraceEvent* out, int64_t cap) {
  return static_cast<Tracer*>(t)->dump(out, cap);
}

double dvs_now() { return now_seconds(); }

}  // extern "C"
