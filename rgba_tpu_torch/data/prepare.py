"""Loader factories over the port's ``BatchLoader`` (port of
``rgba_tpu/data/prepare.py``, after the reference's MYprepare.py)."""

from __future__ import annotations

from .datasets import KodakDataset, RGBATrainDataset
from .loader import BatchLoader


def prepare_dataset_train_COCOP3M(batch_size=1,
                                  COCOrootpath="../P3Mdata/COCOdata",
                                  P3Mrootpath="../P3Mdata/MASKpatches",
                                  height=256, width=256,
                                  fill_mix_ratio=0.25, seed=0):
    ds = RGBATrainDataset(COCOrootpath, P3Mrootpath, height, width,
                          fill_mix_ratio, seed)
    return BatchLoader(ds, batch_size, shuffle=True, num_workers=4,
                       seed=seed), ds


def prepare_dataset_train_COCO(batch_size=1,
                               COCOrootpath="../P3Mdata/COCOdata",
                               height=256, width=256, fill_mix_ratio=0.25,
                               seed=0):
    ds = RGBATrainDataset(COCOrootpath, None, height, width,
                          fill_mix_ratio, seed)
    return BatchLoader(ds, batch_size, shuffle=True, num_workers=4,
                       seed=seed), ds


def prepare_dataset_Kodak(batch_size=1, rootpath="../Kodak"):
    ds = KodakDataset(rootpath)
    return BatchLoader(ds, batch_size, shuffle=False, num_workers=4,
                       drop_last=False), ds


def prepare_dataset_P3Meval(batch_size=1, rootpath="../P3M-500-NP"):
    ds = KodakDataset(rootpath, img_ext="jpg")
    return BatchLoader(ds, batch_size, shuffle=False, num_workers=4,
                       drop_last=False), ds
