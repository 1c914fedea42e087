"""Model encryption at rest — counterpart of
``paddle_tpu.framework.io_crypto``: ``CipherUtils`` (keys), ``AESCipher``
(AES-GCM) and ``is_encrypted``, with the reference's wire format, so
either package reads what the other wrote with the same key:

    b"PDENC\\x01" | 12-byte nonce | AES-256-GCM ciphertext (with its tag)

with the magic as the associated data. The cipher is the host's
``cryptography`` package, imported when a cipher is made; where it is
missing, ``AESCipher`` raises an ``ImportError`` that names it.
"""
from __future__ import annotations

import os

__all__ = ["CipherUtils", "AESCipher", "is_encrypted", "MAGIC"]

MAGIC = b"PDENC\x01"
_NONCE = 12
_KEY_BYTES = (16, 24, 32)


class CipherUtils:
    """Key helpers."""

    @staticmethod
    def gen_key(bits: int = 256) -> bytes:
        if bits not in (128, 192, 256):
            raise ValueError("AES key must be 128/192/256 bits")
        return os.urandom(bits // 8)

    @staticmethod
    def gen_key_to_file(path: str, bits: int = 256) -> bytes:
        key = CipherUtils.gen_key(bits)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(key)
        return key

    @staticmethod
    def read_key_from_file(path: str) -> bytes:
        """The key in ``path``; a trailing newline is dropped when the
        key is a valid length without it."""
        with open(path, "rb") as f:
            key = f.read()
        if len(key) in _KEY_BYTES:
            return key
        stripped = key.rstrip(b"\r\n")
        if len(stripped) in _KEY_BYTES:
            return stripped
        raise ValueError(
            f"key file {path!r} holds {len(key)} bytes; AES needs "
            "16/24/32 (was the key written with a trailing newline "
            "or hex-encoded?)")


class AESCipher:
    """AES-GCM: authenticated, so a tampered artifact fails at load."""

    def __init__(self, key: bytes):
        if len(key) not in _KEY_BYTES:
            raise ValueError("AES key must be 16/24/32 bytes")
        try:
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        except ImportError as e:
            raise ImportError(
                "encrypted artifacts (cipher_key) need the cryptography "
                "package, which is not installed") from e
        self._aead = AESGCM(key)

    def encrypt(self, plaintext: bytes) -> bytes:
        nonce = os.urandom(_NONCE)
        return MAGIC + nonce + self._aead.encrypt(nonce, plaintext, MAGIC)

    def decrypt(self, blob: bytes) -> bytes:
        if not blob.startswith(MAGIC):
            raise ValueError("not an encrypted artifact (missing PDENC magic)")
        nonce = blob[len(MAGIC):len(MAGIC) + _NONCE]
        return self._aead.decrypt(nonce, blob[len(MAGIC) + _NONCE:], MAGIC)

    def encrypt_to_file(self, plaintext: bytes, path: str):
        with open(path, "wb") as f:
            f.write(self.encrypt(plaintext))

    def decrypt_from_file(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return self.decrypt(f.read())


def is_encrypted(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False
