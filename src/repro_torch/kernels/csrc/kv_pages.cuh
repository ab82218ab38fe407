// Where a paged KV write puts a row: the page rule the writes share
// (kv_append.cu for the decode append and the chunk write, kv_prefill.cu for
// the whole-prompt prefill), so the two kernels cannot drift apart.
//
// Row j of a slot sits at position pos; `table` is the slot's row of the
// page table (pages_per_slot entries); `act` is the slot's active flag and
// `nv` its count of valid rows. A row that writes no real page goes to the
// trash page: an inactive slot, a pad row (j >= nv), a negative position, a
// page number outside the pool, and, under the drop rule (clamp_last = 0,
// the reference's append_token), a position past the slot's last page.
// Under the clamp rule (clamp_last = 1, the reference's write_chunk and
// write_prefill, whose gathers clamp the page index) such a row lands in the
// last page; two valid rows j and j + page_size past the last page's start
// then meet in one cell, the reference's scatter keeps the later, and so the
// earlier goes to the trash page here, whatever order the CTAs run in.

#pragma once

namespace kv_pages {

__device__ __forceinline__ int row_page(const int* table, int pages_per_slot, int page_size,
                                        int trash, int clamp_last, int j, int pos, bool act,
                                        int nv) {
  if (!act || j >= nv || pos < 0) return trash;
  int idx = pos / page_size;
  if (clamp_last && idx >= pages_per_slot - 1) {
    if (j + page_size < nv) return trash;   // a later row writes this cell
    idx = pages_per_slot - 1;
  }
  if (idx >= pages_per_slot) return trash;
  const int page = __ldg(table + idx);
  return page < 0 || page > trash ? trash : page;
}

}  // namespace kv_pages
