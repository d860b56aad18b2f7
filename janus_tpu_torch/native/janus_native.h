/* C API of the port's crypto library: the crypto part of the JAX
 * package's native header (counterpart: janus_tpu/native/janus_native.h),
 * built from sha256.cc and ecdsa.cc into libjanus_crypto.so by
 * janus_tpu_torch/net/binding.py.
 *
 * Everything crosses this API as plain C types for ctypes binding.
 */
#ifndef JANUS_NATIVE_H_
#define JANUS_NATIVE_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- SHA-256 (block/update digests; reference Block.ComputeDigest,
 * DAGConsensus/Block.cs:45-73) ---- */
void janus_sha256(const uint8_t* data, size_t len, uint8_t out32[32]);

/* ---- ECDSA P-256 via the system libcrypto (dlopen'd; no headers).
 * Returns 0 on success, negative on error/unavailable. Keys/sigs are DER
 * blobs. (reference: Replica ECDSA keypair, DAGConsensus/Replica.cs:34-42,
 * Block.Sign/Verify :75-88) ---- */
int janus_ecdsa_available(void);
int janus_ecdsa_keygen(uint8_t* priv_der, int* priv_len /*in:cap out:len*/,
                       uint8_t* pub_der, int* pub_len);
int janus_ecdsa_sign(const uint8_t* priv_der, int priv_len,
                     const uint8_t* msg, size_t msg_len,
                     uint8_t* sig_der, int* sig_len);
int janus_ecdsa_verify(const uint8_t* pub_der, int pub_len,
                       const uint8_t* msg, size_t msg_len,
                       const uint8_t* sig_der, int sig_len);

#ifdef __cplusplus
}
#endif

#endif  // JANUS_NATIVE_H_
