// ECDSA P-256 sign/verify through the system libcrypto, loaded with
// dlopen (the image ships libcrypto.so.3 without headers). Covers the
// role of the reference's .NET ECDsa wrappers (DAGConsensus/Replica.cs:
// 34-42 keygen; Block.Sign/Verify :75-88). All functions return negative
// codes when libcrypto is unavailable so pure-emulation runs degrade to
// the in-sim integrity model.
#include "janus_native.h"

#include <dlfcn.h>

#include <cstring>
#include <mutex>

namespace {

// Minimal EVP surface, declared locally (stable libcrypto ABI).
struct EvpApi {
  void* (*EVP_PKEY_CTX_new_id)(int id, void* e);
  int (*EVP_PKEY_keygen_init)(void* ctx);
  int (*EVP_PKEY_CTX_ctrl)(void* ctx, int keytype, int optype, int cmd,
                           int p1, void* p2);
  int (*EVP_PKEY_keygen)(void* ctx, void** pkey);
  void (*EVP_PKEY_CTX_free)(void* ctx);
  void (*EVP_PKEY_free)(void* pkey);
  int (*i2d_PrivateKey)(void* pkey, uint8_t** out);
  int (*i2d_PUBKEY)(void* pkey, uint8_t** out);
  void* (*d2i_AutoPrivateKey)(void** pkey, const uint8_t** in, long len);
  void* (*d2i_PUBKEY)(void** pkey, const uint8_t** in, long len);
  void* (*EVP_MD_CTX_new)(void);
  void (*EVP_MD_CTX_free)(void* ctx);
  const void* (*EVP_sha256)(void);
  int (*EVP_DigestSignInit)(void* ctx, void** pctx, const void* md, void* e,
                            void* pkey);
  int (*EVP_DigestSign)(void* ctx, uint8_t* sig, size_t* siglen,
                        const uint8_t* tbs, size_t tbslen);
  int (*EVP_DigestVerifyInit)(void* ctx, void** pctx, const void* md, void* e,
                              void* pkey);
  int (*EVP_DigestVerify)(void* ctx, const uint8_t* sig, size_t siglen,
                          const uint8_t* tbs, size_t tbslen);
  bool ok = false;
};

constexpr int kEVP_PKEY_EC = 408;
// EVP_PKEY_CTX_set_ec_paramgen_curve_nid macro constants:
constexpr int kEVP_PKEY_OP_KEYGEN = 1 << 2;
constexpr int kEVP_PKEY_OP_PARAMGEN = 1 << 1;
constexpr int kEVP_PKEY_CTRL_EC_PARAMGEN_CURVE_NID = 0x1000 + 1;
constexpr int kNID_X9_62_prime256v1 = 415;

EvpApi* api() {
  static EvpApi a;
  static std::once_flag once;
  std::call_once(once, [] {
    void* h = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libcrypto.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return;
    auto sym = [&](const char* n) { return dlsym(h, n); };
#define LOAD(field, name)                                   \
  a.field = reinterpret_cast<decltype(a.field)>(sym(name)); \
  if (!a.field) return;
    LOAD(EVP_PKEY_CTX_new_id, "EVP_PKEY_CTX_new_id")
    LOAD(EVP_PKEY_keygen_init, "EVP_PKEY_keygen_init")
    LOAD(EVP_PKEY_CTX_ctrl, "EVP_PKEY_CTX_ctrl")
    LOAD(EVP_PKEY_keygen, "EVP_PKEY_keygen")
    LOAD(EVP_PKEY_CTX_free, "EVP_PKEY_CTX_free")
    LOAD(EVP_PKEY_free, "EVP_PKEY_free")
    LOAD(i2d_PrivateKey, "i2d_PrivateKey")
    LOAD(i2d_PUBKEY, "i2d_PUBKEY")
    LOAD(d2i_AutoPrivateKey, "d2i_AutoPrivateKey")
    LOAD(d2i_PUBKEY, "d2i_PUBKEY")
    LOAD(EVP_MD_CTX_new, "EVP_MD_CTX_new")
    LOAD(EVP_MD_CTX_free, "EVP_MD_CTX_free")
    LOAD(EVP_sha256, "EVP_sha256")
    LOAD(EVP_DigestSignInit, "EVP_DigestSignInit")
    LOAD(EVP_DigestSign, "EVP_DigestSign")
    LOAD(EVP_DigestVerifyInit, "EVP_DigestVerifyInit")
    LOAD(EVP_DigestVerify, "EVP_DigestVerify")
#undef LOAD
    a.ok = true;
  });
  return &a;
}

}  // namespace

extern "C" int janus_ecdsa_available(void) { return api()->ok ? 1 : 0; }

extern "C" int janus_ecdsa_keygen(uint8_t* priv_der, int* priv_len,
                                  uint8_t* pub_der, int* pub_len) {
  EvpApi* a = api();
  if (!a->ok) return -1;
  void* ctx = a->EVP_PKEY_CTX_new_id(kEVP_PKEY_EC, nullptr);
  if (!ctx) return -2;
  int rc = -3;
  void* pkey = nullptr;
  if (a->EVP_PKEY_keygen_init(ctx) > 0 &&
      a->EVP_PKEY_CTX_ctrl(ctx, kEVP_PKEY_EC,
                           kEVP_PKEY_OP_KEYGEN | kEVP_PKEY_OP_PARAMGEN,
                           kEVP_PKEY_CTRL_EC_PARAMGEN_CURVE_NID,
                           kNID_X9_62_prime256v1, nullptr) > 0 &&
      a->EVP_PKEY_keygen(ctx, &pkey) > 0) {
    // i2d with a non-null pointer writes the FULL encoding before any
    // length check could run, so query the lengths first (null output
    // pointer) and only encode once both fit the caller's buffers.
    int n = a->i2d_PrivateKey(pkey, nullptr);
    int m = a->i2d_PUBKEY(pkey, nullptr);
    if (n > 0 && m > 0 && n <= *priv_len && m <= *pub_len) {
      uint8_t* p = priv_der;
      uint8_t* q = pub_der;
      if (a->i2d_PrivateKey(pkey, &p) == n && a->i2d_PUBKEY(pkey, &q) == m) {
        *priv_len = n;
        *pub_len = m;
        rc = 0;
      }
    }
  }
  if (pkey) a->EVP_PKEY_free(pkey);
  a->EVP_PKEY_CTX_free(ctx);
  return rc;
}

extern "C" int janus_ecdsa_sign(const uint8_t* priv_der, int priv_len,
                                const uint8_t* msg, size_t msg_len,
                                uint8_t* sig_der, int* sig_len) {
  EvpApi* a = api();
  if (!a->ok) return -1;
  const uint8_t* p = priv_der;
  void* pkey = a->d2i_AutoPrivateKey(nullptr, &p, priv_len);
  if (!pkey) return -2;
  void* md = a->EVP_MD_CTX_new();
  int rc = -3;
  size_t slen = size_t(*sig_len);
  if (md && a->EVP_DigestSignInit(md, nullptr, a->EVP_sha256(), nullptr,
                                  pkey) > 0 &&
      a->EVP_DigestSign(md, sig_der, &slen, msg, msg_len) > 0) {
    *sig_len = int(slen);
    rc = 0;
  }
  if (md) a->EVP_MD_CTX_free(md);
  a->EVP_PKEY_free(pkey);
  return rc;
}

extern "C" int janus_ecdsa_verify(const uint8_t* pub_der, int pub_len,
                                  const uint8_t* msg, size_t msg_len,
                                  const uint8_t* sig_der, int sig_len) {
  EvpApi* a = api();
  if (!a->ok) return -1;
  const uint8_t* p = pub_der;
  void* pkey = a->d2i_PUBKEY(nullptr, &p, pub_len);
  if (!pkey) return -2;
  void* md = a->EVP_MD_CTX_new();
  int rc = -3;
  if (md && a->EVP_DigestVerifyInit(md, nullptr, a->EVP_sha256(), nullptr,
                                    pkey) > 0) {
    rc = a->EVP_DigestVerify(md, sig_der, size_t(sig_len), msg, msg_len) == 1
             ? 0
             : 1; /* 1 = bad signature */
  }
  if (md) a->EVP_MD_CTX_free(md);
  a->EVP_PKEY_free(pkey);
  return rc;
}
