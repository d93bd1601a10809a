"""Vision datasets for the port (counterpart of `paddle_tpu/vision/datasets.py`).

Nothing is downloaded: Cifar10, Cifar100, MNIST, FashionMNIST, Flowers
and VOC2012 read local files, DatasetFolder and ImageFolder a directory;
FakeData gives deterministic synthetic samples (`RandomState(seed +
idx)`, the same samples as the reference's). Samples are numpy, so the
`DataLoader`'s workers can make them; PIL is imported only where an image
file is decoded.
"""
import os
import pickle
import tarfile

import numpy as np

from ..io import Dataset


class FakeData(Dataset):
    """Deterministic synthetic image-classification data."""

    def __init__(self, num_samples=1000, image_shape=(3, 32, 32), num_classes=10,
                 transform=None, seed=0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        img = rng.rand(*self.image_shape).astype(np.float32)
        label = np.asarray(rng.randint(0, self.num_classes), dtype=np.int64)
        if self.transform:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.num_samples


class Cifar10(Dataset):
    """Reads the standard python-pickle CIFAR-10 archive from data_file."""

    _ARCHIVE = "cifar-10-python.tar.gz"
    _LABEL_KEY = b"labels"

    def _members(self, mode):
        return ([f"cifar-10-batches-py/data_batch_{i}" for i in range(1, 6)]
                if mode == "train" else ["cifar-10-batches-py/test_batch"])

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.transform = transform
        self.mode = mode
        self.data = []
        self.labels = []
        candidates = [data_file,
                      os.path.expanduser(
                          f"~/.cache/paddle/dataset/cifar/{self._ARCHIVE}")]
        path = next((p for p in candidates if p and os.path.exists(p)), None)
        if path is None:
            raise FileNotFoundError(
                f"{self._ARCHIVE} not found (nothing is downloaded); pass "
                "data_file= or use paddle_tpu_torch.vision.datasets.FakeData")
        with tarfile.open(path) as tf:
            for n in self._members(mode):
                with tf.extractfile(n) as f:
                    d = pickle.load(f, encoding="bytes")
                self.data.append(d[b"data"])
                self.labels.extend(d[self._LABEL_KEY])
        self.data = np.concatenate(self.data).reshape(-1, 3, 32, 32)

    def __getitem__(self, idx):
        img = self.data[idx].astype(np.float32) / 255.0
        label = np.asarray(self.labels[idx], dtype=np.int64)
        if self.transform:
            img = self.transform(img.transpose(1, 2, 0))
        return img, label

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    """CIFAR-100: same pickle format, one train/test member each, fine
    labels."""

    _ARCHIVE = "cifar-100-python.tar.gz"
    _LABEL_KEY = b"fine_labels"

    def _members(self, mode):
        return ["cifar-100-python/train" if mode == "train"
                else "cifar-100-python/test"]


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        self.transform = transform
        import gzip
        base = os.path.expanduser("~/.cache/paddle/dataset/mnist")
        prefix = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(base, f"{prefix}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(base, f"{prefix}-labels-idx1-ubyte.gz")
        if not (os.path.exists(image_path) and os.path.exists(label_path)):
            raise FileNotFoundError(
                "MNIST files not found (nothing is downloaded); use FakeData "
                "for smoke tests")
        with gzip.open(image_path, "rb") as f:
            self.images = np.frombuffer(f.read(), np.uint8, offset=16).reshape(-1, 28, 28)
        with gzip.open(label_path, "rb") as f:
            self.labels = np.frombuffer(f.read(), np.uint8, offset=8).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None] / 255.0
        if self.transform:
            img = self.transform(img.transpose(1, 2, 0))
        return img, np.asarray(self.labels[idx], dtype=np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    """Same IDX format as MNIST, another archive (local files)."""
    pass


class DatasetFolder(Dataset):
    """One class per subdirectory; loader and extensions configurable."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._pil_loader
        exts = tuple(extensions or (".jpg", ".jpeg", ".png", ".bmp",
                                    ".gif", ".webp", ".npy"))
        import os
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, names in sorted(os.walk(cdir)):
                for n in sorted(names):
                    path = os.path.join(dirpath, n)
                    ok = is_valid_file(path) if is_valid_file else \
                        n.lower().endswith(exts)
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"no valid samples under {root!r}")

    @staticmethod
    def _pil_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        from PIL import Image
        with open(path, "rb") as f:
            return Image.open(f).convert("RGB")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class ImageFolder(DatasetFolder):
    """An unlabeled folder of images."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os
        self.root = root
        self.transform = transform
        self.loader = loader or DatasetFolder._pil_loader
        exts = tuple(extensions or (".jpg", ".jpeg", ".png", ".bmp",
                                    ".gif", ".webp", ".npy"))
        self.samples = []
        for dirpath, _, names in sorted(os.walk(root)):
            for n in sorted(names):
                path = os.path.join(dirpath, n)
                ok = is_valid_file(path) if is_valid_file else \
                    n.lower().endswith(exts)
                if ok:
                    self.samples.append(path)
        if not self.samples:
            raise RuntimeError(f"no valid samples under {root!r}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return (img,)


class Flowers(Dataset):
    """102 Flowers (image tgz + label/setid .mat) from local files."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        if not (data_file and label_file and setid_file):
            raise RuntimeError(
                "Flowers needs local copies (nothing is downloaded): "
                "data_file=102flowers.tgz, label_file=imagelabels.mat, "
                "setid_file=setid.mat (the reference's cached archives)")
        import scipy.io as sio
        self.transform = transform
        labels = sio.loadmat(label_file)["labels"].ravel()
        setid = sio.loadmat(setid_file)
        key = {"train": "trnid", "valid": "valid", "test": "tstid"}[mode]
        self.indexes = setid[key].ravel()
        self.labels = labels
        self.data_file = data_file
        import tarfile
        self._tar = tarfile.open(data_file)
        self._names = {m.name.split("/")[-1]: m.name
                       for m in self._tar.getmembers()
                       if m.name.endswith(".jpg")}

    def __len__(self):
        return len(self.indexes)

    def __getitem__(self, idx):
        import io
        from PIL import Image
        i = int(self.indexes[idx])
        name = self._names[f"image_{i:05d}.jpg"]
        img = Image.open(io.BytesIO(
            self._tar.extractfile(name).read())).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        return img, int(self.labels[i - 1]) - 1


class VOC2012(Dataset):
    """Segmentation pairs from a local VOCtrainval tar."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        if data_file is None:
            raise RuntimeError(
                "VOC2012 needs a local VOCtrainval_11-May-2012.tar "
                "(nothing is downloaded)")
        import tarfile
        self.transform = transform
        self._tar = tarfile.open(data_file)
        base = "VOCdevkit/VOC2012"
        seg = {"train": "train.txt", "valid": "val.txt",
               "trainval": "trainval.txt", "test": "val.txt"}[mode]
        lst = self._tar.extractfile(
            f"{base}/ImageSets/Segmentation/{seg}").read().decode().split()
        self._pairs = [(f"{base}/JPEGImages/{n}.jpg",
                        f"{base}/SegmentationClass/{n}.png") for n in lst]

    def __len__(self):
        return len(self._pairs)

    def __getitem__(self, idx):
        import io
        from PIL import Image
        ip, lp = self._pairs[idx]
        img = Image.open(io.BytesIO(self._tar.extractfile(ip).read()))
        lab = Image.open(io.BytesIO(self._tar.extractfile(lp).read()))
        img = np.asarray(img.convert("RGB"))
        lab = np.asarray(lab)
        if self.transform is not None:
            img = self.transform(img)
        return img, lab
