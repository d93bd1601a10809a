// Named runtime counters with peak tracking.
// Native equivalent of the reference's StatRegistry / STAT_ADD monitors
// (paddle/fluid/platform/monitor.h:80,133) and the memory peak trackers
// (paddle/fluid/memory/stats.h).
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>

namespace {
struct Stat {
  int64_t value = 0;
  int64_t peak = 0;
};
std::mutex g_mu;
std::map<std::string, Stat> g_stats;
}  // namespace

extern "C" {

int64_t ptn_stat_add(const char* name, int64_t delta) {
  std::lock_guard<std::mutex> g(g_mu);
  Stat& s = g_stats[name];
  s.value += delta;
  if (s.value > s.peak) s.peak = s.value;
  return s.value;
}

int64_t ptn_stat_get(const char* name) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_stats.find(name);
  return it == g_stats.end() ? 0 : it->second.value;
}

int64_t ptn_stat_peak(const char* name) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_stats.find(name);
  return it == g_stats.end() ? 0 : it->second.peak;
}

void ptn_stat_reset(const char* name) {
  std::lock_guard<std::mutex> g(g_mu);
  g_stats.erase(name);
}

}  // extern "C"
