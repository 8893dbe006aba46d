// Native host-side panoptic fusion kernels.
//
// The reference parallelizes its host fusion with multiprocessing pools
// (reference tools/dataset/cityscapes_vps.py:58-87, base_dataset.py:121-156)
// because the per-region numpy loops are slow.  Here the same work is three
// single-pass O(H*W) routines, exported with plain C linkage and loaded via
// ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -shared -fPIC fusion.cpp -o libslotvps_fusion.so
// (done automatically by slotvps_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

// Reconcile semantic argmax vs instance map for one frame
// (reference tools/dataset/cityscapes_vps.py:249-290 region loop).
//
//   seg:      [h*w] uint8 semantic argmax
//   pan:      [h*w] uint8 panoptic map (<= id_last_stuff: stuff class,
//             >  id_last_stuff: instance slot id, 255: void)
//   cls_ind:  [n_ins] int64 thing class (1-based) per instance slot
//   obj_id:   [n_ins] int64 track id per slot (or NULL)
//   outputs pan_seg / pan_ins / pan_obj: [h*w] uint8
//
// Semantics: for each instance region, majority-vote the semantic classes
// inside it; agree -> keep thing; strong stuff majority (>= 0.5) -> stuff;
// else keep thing.  Then stuff regions smaller than stuff_area_limit are
// voided.  Instance indices are renumbered 1..n in slot-id order.
void unify_pan_result(
    const uint8_t* seg, const uint8_t* pan,
    const int64_t* cls_ind, const int64_t* obj_id,
    int64_t n_ins, int64_t h, int64_t w,
    int64_t id_last_stuff, int64_t stuff_area_limit,
    uint8_t* pan_seg, uint8_t* pan_ins, uint8_t* pan_obj) {
  const int64_t n = h * w;
  const int NSEG = 256;   // semantic ids fit uint8
  const int NIDS = 256;   // pan ids fit uint8

  // pass 1: per-instance-region semantic histograms
  // hist[id][cls]
  static thread_local int64_t hist[NIDS][NSEG];
  std::memset(hist, 0, sizeof(hist));
  int64_t region_area[NIDS];
  std::memset(region_area, 0, sizeof(region_area));
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t p = pan[i];
    if (p > id_last_stuff && p != 255) {
      hist[p][seg[i]] += 1;
      region_area[p] += 1;
    }
  }

  // region decisions, indexed by pan id
  uint8_t out_seg_for[NIDS];
  uint8_t out_ins_for[NIDS];
  uint8_t out_obj_for[NIDS];
  int64_t idx = 0;  // enumeration order of present instance ids (ascending)
  for (int id = id_last_stuff + 1; id < NIDS; ++id) {
    if (region_area[id] == 0) continue;
    if (id == 255) continue;
    const int64_t k = id - id_last_stuff - 1;
    const int64_t thing_sem =
        (k >= 0 && k < n_ins) ? cls_ind[k] + id_last_stuff : 255;
    // majority class
    int maj = 0;
    int64_t maj_cnt = -1;
    for (int c = 0; c < NSEG; ++c) {
      if (hist[id][c] > maj_cnt) { maj_cnt = hist[id][c]; maj = c; }
    }
    bool keep_thing;
    if (maj == thing_sem) {
      keep_thing = true;
    } else if (2 * maj_cnt >= region_area[id] && maj <= id_last_stuff) {
      keep_thing = false;
    } else {
      keep_thing = true;
    }
    if (keep_thing) {
      out_seg_for[id] = (uint8_t)thing_sem;
      out_ins_for[id] = (uint8_t)(idx + 1);
      out_obj_for[id] = obj_id ? (uint8_t)(obj_id[idx] + 1) : (uint8_t)id;
    } else {
      out_seg_for[id] = (uint8_t)maj;
      out_ins_for[id] = 0;
      out_obj_for[id] = 0;
    }
    idx += 1;
  }

  // pass 2: write maps + stuff area histogram
  int64_t stuff_area[NSEG];
  std::memset(stuff_area, 0, sizeof(stuff_area));
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t p = pan[i];
    if (p > id_last_stuff && p != 255) {
      pan_seg[i] = out_seg_for[p];
      pan_ins[i] = out_ins_for[p];
      pan_obj[i] = out_obj_for[p];
    } else {
      pan_seg[i] = p;
      pan_ins[i] = (p <= id_last_stuff) ? 0 : p;
      pan_obj[i] = p;
      if (p == 255) pan_ins[i] = 0;
    }
    if (pan_seg[i] <= id_last_stuff) stuff_area[pan_seg[i]] += 1;
  }

  // pass 3: void small stuff
  bool voided[NSEG] = {false};
  bool any = false;
  for (int c = 0; c <= id_last_stuff; ++c) {
    if (stuff_area[c] > 0 && stuff_area[c] < stuff_area_limit) {
      voided[c] = true;
      any = true;
    }
  }
  if (any) {
    for (int64_t i = 0; i < n; ++i) {
      if (pan_seg[i] <= id_last_stuff && voided[pan_seg[i]]) pan_seg[i] = 255;
    }
  }
}

// One-pass region statistics of an int32 key map: unique values, counts,
// bounding boxes (reference convert_2ch_track's per-value np.where loops,
// tools/dataset/cityscapes_vps.py:158-193).
//
//   keys:     [h*w] int32 (e.g. sem*1000 + obj)
//   max_keys: capacity of the output arrays
// returns number of distinct keys found (or -1 on overflow).
int64_t region_stats(
    const int32_t* keys, int64_t h, int64_t w, int64_t max_keys,
    int32_t* out_keys, int64_t* out_count,
    int64_t* out_x0, int64_t* out_y0, int64_t* out_x1, int64_t* out_y1) {
  // open-addressed hash table
  const int64_t cap = 4096;  // > max distinct keys per frame
  int32_t table_key[cap];
  int64_t table_slot[cap];
  for (int64_t i = 0; i < cap; ++i) table_key[i] = -1;
  int64_t n_found = 0;

  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      const int32_t key = keys[y * w + x];
      uint64_t hsh = ((uint64_t)(uint32_t)key * 2654435761u) & (cap - 1);
      while (table_key[hsh] != key && table_key[hsh] != -1) {
        hsh = (hsh + 1) & (cap - 1);
      }
      int64_t slot;
      if (table_key[hsh] == key) {
        slot = table_slot[hsh];
      } else {
        if (n_found >= max_keys) return -1;
        table_key[hsh] = key;
        table_slot[hsh] = n_found;
        slot = n_found;
        out_keys[slot] = key;
        out_count[slot] = 0;
        out_x0[slot] = w; out_y0[slot] = h;
        out_x1[slot] = -1; out_y1[slot] = -1;
        n_found += 1;
      }
      out_count[slot] += 1;
      if (x < out_x0[slot]) out_x0[slot] = x;
      if (y < out_y0[slot]) out_y0[slot] = y;
      if (x > out_x1[slot]) out_x1[slot] = x;
      if (y > out_y1[slot]) out_y1[slot] = y;
    }
  }
  return n_found;
}

// Paint regions by key -> RGB color lookup (one pass).
//   keys: [h*w] int32; color table: n_keys x (key, r, g, b)
void paint_regions(
    const int32_t* keys, int64_t h, int64_t w,
    const int32_t* lut_keys, const uint8_t* lut_rgb, int64_t n_lut,
    uint8_t* out_rgb) {
  const int64_t cap = 4096;
  int32_t table_key[cap];
  int64_t table_idx[cap];
  for (int64_t i = 0; i < cap; ++i) table_key[i] = -1;
  for (int64_t j = 0; j < n_lut; ++j) {
    uint64_t hsh = ((uint64_t)(uint32_t)lut_keys[j] * 2654435761u) & (cap - 1);
    while (table_key[hsh] != -1) hsh = (hsh + 1) & (cap - 1);
    table_key[hsh] = lut_keys[j];
    table_idx[hsh] = j;
  }
  const int64_t n = h * w;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t key = keys[i];
    uint64_t hsh = ((uint64_t)(uint32_t)key * 2654435761u) & (cap - 1);
    int64_t j = -1;
    while (table_key[hsh] != -1) {
      if (table_key[hsh] == key) { j = table_idx[hsh]; break; }
      hsh = (hsh + 1) & (cap - 1);
    }
    if (j >= 0) {
      out_rgb[3 * i + 0] = lut_rgb[3 * j + 0];
      out_rgb[3 * i + 1] = lut_rgb[3 * j + 1];
      out_rgb[3 * i + 2] = lut_rgb[3 * j + 2];
    } else {
      out_rgb[3 * i + 0] = 0;
      out_rgb[3 * i + 1] = 0;
      out_rgb[3 * i + 2] = 0;
    }
  }
}

}  // extern "C"
