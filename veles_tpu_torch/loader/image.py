"""Image loaders — decode, scale, crop, color-convert image datasets.

Port of ``veles_tpu/loader/image.py``.  Ref: veles/loader/image.py::
ImageLoader/FileImageLoader + veles/loader/file_image.py::
FullBatchImageLoader variants [H] (SURVEY §2.2).  Behavior preserved:
directory datasets (one class per subdirectory) and explicit file lists;
PIL decode (PIL is imported inside ``decode_image``); scale to a fixed
(H, W); optional center crop; GRAY or RGB color space; pixel scaling to
[-1, 1] (or a configured normalizer).  Everything is decoded once at
load time into one device-resident array (FullBatch semantics) —
per-step augmentation belongs to the sample pipelines (see
samples/imagenet.py), not the loader hot path.
"""

from __future__ import annotations

import os

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".gif", ".tif",
              ".tiff", ".webp")


def decode_image(path, size=None, color_space="RGB", crop=None):
    """Decode one image file to a float32 HWC array in [0, 255].

    ``size`` is (H, W) for PIL-resize; ``crop`` is (H, W) center crop applied
    after the resize (the reference's scale/crop options).
    """
    from PIL import Image
    with Image.open(path) as img:
        mode = "L" if color_space in ("GRAY", "L") else "RGB"
        img = img.convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]), Image.BILINEAR)
        arr = numpy.asarray(img, numpy.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if crop is not None:
        ch, cw = crop
        h, w = arr.shape[:2]
        if ch > h or cw > w:
            raise ValueError(
                "crop %s exceeds image size %s for %s (resize first or "
                "shrink the crop)" % ((ch, cw), (h, w), path))
        top, left = (h - ch) // 2, (w - cw) // 2
        arr = arr[top:top + ch, left:left + cw]
    return arr


def scan_directory(directory):
    """(paths, class_names_per_path): one class per subdirectory, sorted
    for determinism; images directly inside ``directory`` get the directory
    name as their class."""
    classes = sorted(
        d for d in os.listdir(directory)
        if os.path.isdir(os.path.join(directory, d)))
    paths, names = [], []
    if classes:
        for cls in classes:
            base = os.path.join(directory, cls)
            for fname in sorted(os.listdir(base)):
                if fname.lower().endswith(IMAGE_EXTS):
                    paths.append(os.path.join(base, fname))
                    names.append(cls)
    else:
        own = os.path.basename(directory.rstrip(os.sep))
        for fname in sorted(os.listdir(directory)):
            if fname.lower().endswith(IMAGE_EXTS):
                paths.append(os.path.join(directory, fname))
                names.append(own)
    return paths, names


class FullBatchImageLoader(FullBatchLoader):
    """Decode a [test|valid|train] split of image files onto the device.

    Each split is either a directory (class-per-subdir) or an explicit list
    of (path, label) pairs; empty splits are allowed (the reference's
    test/validation-less datasets).
    """

    def __init__(self, workflow, test_paths=None, validation_paths=None,
                 train_paths=None, scale=(32, 32), crop=None,
                 color_space="RGB", **kwargs):
        kwargs.setdefault("normalization_type", "linear")
        super().__init__(workflow, **kwargs)
        self.split_sources = [test_paths, validation_paths, train_paths]
        self.scale = tuple(scale)
        self.crop = tuple(crop) if crop else None
        self.color_space = color_space
        self.label_names = []

    def load_data(self):
        # pass 1: scan every directory split so ALL splits share ONE
        # class-name → label map (per-split enumeration would silently give
        # the same class different indices in train vs valid)
        scanned = []
        class_names = set()
        for source in self.split_sources:
            if isinstance(source, str):
                paths, names = scan_directory(source)
                scanned.append(("dir", paths, names))
                class_names.update(names)
            elif source:
                paths, lbls = zip(*source)
                scanned.append(("list", list(paths), list(lbls)))
            else:
                scanned.append(("empty", [], []))
        self.label_names = sorted(class_names)
        label_of = {name: i for i, name in enumerate(self.label_names)}

        arrays, labels, lengths = [], [], []
        for kind, paths, extra in scanned:
            lengths.append(len(paths))
            if kind == "dir":
                labels.extend(label_of[n] for n in extra)
            else:
                labels.extend(extra)
            for path in paths:
                arrays.append(decode_image(path, self.scale,
                                           self.color_space, self.crop))
        if not arrays:
            raise ValueError("%s: no images found" % self.name)
        self.original_data.reset(numpy.stack(arrays))
        self.original_labels.reset(numpy.asarray(labels, numpy.int32))
        self.class_lengths = lengths
        self.info("decoded %d images (%s) → %s", len(arrays),
                  "/".join(str(n) for n in lengths),
                  self.original_data.shape)


class AutoSplitImageLoader(FullBatchImageLoader):
    """One directory, deterministic validation split by index stride.

    Ref: the reference's auto-label file image loaders with
    ``validation_ratio`` [M].
    """

    def __init__(self, workflow, directory, validation_ratio=0.15, **kwargs):
        super().__init__(workflow, **kwargs)
        self.directory = directory
        self.validation_ratio = float(validation_ratio)

    def load_data(self):
        paths, names = scan_directory(self.directory)
        if not paths:
            raise ValueError("%s: no images in %s" % (self.name,
                                                      self.directory))
        label_of = {name: i for i, name in enumerate(sorted(set(names)))}
        stride = (int(round(1.0 / self.validation_ratio))
                  if self.validation_ratio > 0 else 0)
        valid, train = [], []
        for i, (path, name) in enumerate(zip(paths, names)):
            pair = (path, label_of[name])
            (valid if stride and i % stride == 0 else train).append(pair)
        self.split_sources = [None, valid, train]
        super().load_data()
        self.label_names = sorted(label_of)
