"""ZL001 fixtures for the port: view-local vs physical page-id provenance.

Never imported at runtime -- parsed by the analyzer only.  Lines that
MUST be flagged carry an ``# EXPECT[ZL001]`` marker; every other line
must stay clean (the test asserts exact set equality, so the correct
idioms double as negative cases).  The rule is the reference's; the
sinks here are the port's (a page table staged for the paged-attention
kernel, index tensors into the store's page tensors).
"""

import numpy as np
import torch


# -- violations -------------------------------------------------------------

def free_view_ids_into_pool(pool, req):
    pool._give(req.pages)  # EXPECT[ZL001]


def kernel_sees_view_ids(req):
    return page_table(pages=req.pages)  # EXPECT[ZL001]


def double_translation(view, req):
    phys = view.to_physical(req.pages)
    return view.to_physical(phys)  # EXPECT[ZL001]


def physical_ids_stored_on_request(view, req):
    phys = view.to_physical(req.pages)
    req.pages = phys  # EXPECT[ZL001]


def physical_ids_extended_onto_request(view, req):
    phys = view.to_physical_local(req.local_pages)
    req.local_pages.extend(phys)  # EXPECT[ZL001]


def view_ids_pushed_onto_physical_free_list(self, req):
    self.free_local.extend(req.pages)  # EXPECT[ZL001]


def view_taint_through_list_copy(pool, req):
    ids = list(req.pages)
    pool._give(ids)  # EXPECT[ZL001]


def cache_fed_view_ids(req):
    req.shared_pages = list(req.pages)  # EXPECT[ZL001]


# -- correct idioms (must NOT be flagged) -----------------------------------

def correct_free(pool, view, req):
    phys = view.to_physical(req.pages)
    pool._give(phys)


def correct_kernel(view, req):
    table = list(req.shared_pages) + view.to_physical(req.pages)
    return page_table(pages=table)


def correct_index_tensor(view, req, device):
    idx = np.asarray(view.to_physical(req.pages), np.int64)
    return torch.as_tensor(idx, device=device)


def correct_grant_extends_view_ids(view, req):
    req.pages.extend(view._alloc(2))


def correct_physical_free_list(self, view, req):
    self.free_local.extend(view.to_physical_local(req.local_pages))


def page_table(pages=None):
    return pages
